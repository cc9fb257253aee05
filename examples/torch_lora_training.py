"""End-to-end training on the PyTorch/CUDA port, the twin of
``examples/lora_training.py``: train a ~100M-parameter model with LoRA
adapters for a few hundred steps on the synthetic stream, with
checkpointing and an injected failure to demonstrate restart (paper task 2
at framework level — the TASKGRAPH-level LoRA workload is fig11's).

    PYTHONPATH=src python examples/torch_lora_training.py [--steps 200] \\
        [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.ft.supervisor import Supervisor
from repro_torch.models import build_model
from repro_torch.models.lora import lora_init, make_lora_loss
from repro_torch.train.optim import AdamW
from repro_torch.train.step import make_train_step
from repro_torch.train.tree import leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--inject-failure", action="store_true", default=True)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--save-every", type=int, default=25)
    args = ap.parse_args(argv)

    # ~100M params at the defaults: 8L x d512 (vocab 8192)
    d = args.d_model
    cfg = ArchConfig(name="demo-100m", family="dense", n_layers=args.layers,
                     d_model=d, n_heads=8, n_kv_heads=8, d_ff=4 * d,
                     vocab_size=8192, dtype="float32")
    model = build_model(cfg, device=args.device)
    base = model.init(torch.Generator().manual_seed(0))
    n_base = sum(x.numel() for x in leaves(base))
    adapters = lora_init(torch.Generator().manual_seed(1), base, rank=8)
    n_ad = sum(x.numel() for x in leaves(adapters))
    print(f"base params: {n_base/1e6:.1f}M; LoRA params: {n_ad/1e6:.2f}M")

    opt = AdamW(lr=1e-3)
    loss_fn = make_lora_loss(model, base, rank=8)
    state = {"params": adapters, "opt": opt.init(adapters),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    step = make_train_step(model, opt, loss_fn=loss_fn)
    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, 64, 8))
    crashes = {"armed": args.inject_failure}

    def step_fn(state, batch):
        s = int(state["step"])
        if crashes["armed"] and s == args.steps // 2:
            crashes["armed"] = False
            raise RuntimeError("injected node failure")
        state, m = step(state, batch)
        if s % 20 == 0:
            print(f"step {s:4d}: loss {float(m['loss']):.4f}")
        return state, m

    ckpt_dir = tempfile.mkdtemp(prefix="lora_ckpt_")
    sup = Supervisor(ckpt_dir=ckpt_dir, save_every=args.save_every)
    state, report = sup.run(state, step_fn, lambda s: stream.batch(s),
                            args.steps)
    print(f"finished at step {report.final_step} with "
          f"{report.restarts} restart(s); history={report.history}")


if __name__ == "__main__":
    main()
