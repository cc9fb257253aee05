"""Online serving at example scale on the PyTorch/CUDA port, the twin of
``examples/continuous_batching.py``: a request queue drains through the
continuous-batching engine on the card while the KV cache pages cold
blocks to host RAM (pre-compiled bucketed decode plans, static block
extents, transfers on dedicated copy streams).

    PYTHONPATH=src python examples/torch_continuous_batching.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import build_model
from repro_torch.serve import Engine, ServeConfig, naive_generate


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--requests", type=int, default=6)
    args = ap.parse_args(argv)
    cfg = ArchConfig(name="demo-8m", family="dense", n_layers=4,
                     d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                     vocab_size=512, dtype="float32")
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(1, cfg.vocab_size, rng.integers(8, 40)))
               for _ in range(args.requests)]
    serve_cfg = ServeConfig(
        max_len=128, batch_buckets=(1, 2, 4), block_size=16,
        offload=True, hot_window=16,      # mirror cold KV blocks to host
        preempt_every=6,                  # time-slice so waiters get in
    )
    eng = Engine(model, params, serve_cfg)
    outs = eng.generate(prompts, max_new=16)
    print("request  prompt_len  tokens (first 8)")
    ok = True
    for i, (p, o) in enumerate(zip(prompts, outs)):
        ref = naive_generate(model, params, p, max_new=16, max_len=128,
                             rid=i)
        ok &= o == ref
        print(f"{i:7d} {len(p):11d}  {o[:8]}")
    st = eng.stats
    print(f"\nmatches unbatched oracle: {ok}")
    print(f"decode steps {st.decode_steps}, tokens {st.tokens} "
          f"({st.decode_tok_s:.0f} tok/s), swaps {st.swaps}")
    print(f"d2h offload traffic {st.offload_bytes / 2**20:.2f} MiB "
          f"({st.offloaded_fraction:.0%} of the KV bytes produced — "
          f"swap thrash can push this past 100%), h2d reload traffic "
          f"{st.reload_bytes / 2**20:.2f} MiB — all on copy streams; "
          f"decode stalled {st.stall_time * 1e3:.1f} ms")
    eng.close()


if __name__ == "__main__":
    main()
