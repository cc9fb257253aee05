"""TURNIP core: TASKGRAPH → MEMGRAPH compilation and nondeterministic
execution (the paper's primary contribution), ported to PyTorch and CUDA.
"""
from .taskgraph import OpKind, TaskGraph, TaskVertex, TensorSpec
from .memgraph import DepKind, Loc, MemGraph, MemOp, MemVertex, RaceError
from .analyze import (Certificate, PlanCertificationError, PlanHazard,
                      certify)
from .liveness import (LeaseSpec, LivenessCertificate, LivenessModelError,
                       PoolConfig, ProgressCertificationError, StreamConfig,
                       certify_progress, default_pool_config)
from .build import BuildConfig, BuildResult, MemgraphOOM, build_memgraph
from .compile import CompiledPlan, PlanCompileError, lower
from .dispatch import DispatchPolicy, POLICY_NAMES, get_policy
from .stores import DiskStore, HostStore, TieredStore
from .pool import (ARBITRATION_POLICY_NAMES, ArbitrationPolicy, HostPool,
                   Lease, LeaseRefusal, get_arbitration_policy)

__all__ = [
    "OpKind", "TaskGraph", "TaskVertex", "TensorSpec",
    "DepKind", "Loc", "MemGraph", "MemOp", "MemVertex", "RaceError",
    "Certificate", "PlanCertificationError", "PlanHazard", "certify",
    "LeaseSpec", "LivenessCertificate", "LivenessModelError", "PoolConfig",
    "ProgressCertificationError", "StreamConfig", "certify_progress",
    "default_pool_config",
    "BuildConfig", "BuildResult", "MemgraphOOM", "build_memgraph",
    "CompiledPlan", "PlanCompileError", "lower",
    "DispatchPolicy", "POLICY_NAMES", "get_policy",
    "DiskStore", "HostStore", "TieredStore",
    "ARBITRATION_POLICY_NAMES", "ArbitrationPolicy", "HostPool",
    "Lease", "LeaseRefusal", "get_arbitration_policy",
]
