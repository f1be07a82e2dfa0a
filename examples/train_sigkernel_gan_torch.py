"""End-to-end driver of the PyTorch port: train a sequence generator against
a signature-kernel MMD score, the workload pySigLib exists to accelerate
(neural-SDE-style market generation [16, 21, 24]).

A transformer backbone (reduced deepseek-7b family by default; --full-100m
builds a ~113M-parameter generator) maps noise paths to generated paths;
the loss is the biased signature-kernel MMD² against GBM target paths,
differentiated through the exact one-pass backward (paper §3.4), which on
the card runs the Goursat kernels.  The PyTorch counterpart of
``examples/train_sigkernel_gan.py``; it runs on the card unless given
``--device cpu``.

    PYTHONPATH=src python examples/train_sigkernel_gan_torch.py --steps 200
"""

import argparse
import time

import torch

from repro_torch.api import card_device
from repro_torch.core import losses
from repro_torch.core.config import GridConfig, TransformPipeline
from repro_torch.data.synthetic import gbm_paths, step_generator
from repro_torch.models import ParamTree, get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, cosine_schedule

NOISE_DIM = 8


class Generator(ParamTree):
    """Noise path (B, L, noise_dim) -> generated path (B, L, path_dim),
    pinned at 0.  Parameters under the JAX example's names (``in_proj``,
    ``layers.*``, ``norm.scale``, ``out_proj``)."""

    def __init__(self, cfg, tree):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, noise):
        p = self.tree()
        x = noise @ p["in_proj"]
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = T.stack_apply(p["layers"], x, positions, self.cfg)
        x = L.rmsnorm(p["norm"], x, self.cfg.norm_eps)
        path = torch.cumsum(x @ p["out_proj"], dim=1)   # increments -> path
        return path - path[:, :1]                       # pin at 0


def build_generator(cfg, path_dim: int, noise_dim: int, *, seed: int = 0,
                    device=None) -> Generator:
    """The generator with parameters drawn from ``seed``, on the card unless
    ``device="cpu"``.

    ``out_proj`` starts at scale 0.02 / d_model, where the JAX example's
    starts at 0.02: the initial increments, about 0.02·√d_model a channel
    there, are 0.55 at the ``--full-100m`` width, and over 256 steps the
    paths' signature kernel overflows float32, so the loss is NaN from the
    first step.  At 0.02 / d_model they are 0.02 / √d_model, small at any
    width.  (The tests carry the JAX example's own parameters across.)"""
    g = torch.Generator(device=card_device(device, "build_generator"))
    g.manual_seed(seed)
    return Generator(cfg, {
        "in_proj": L.dense_init(g, noise_dim, cfg.d_model),
        "layers": T.stack_init(g, cfg),
        "norm": L.rmsnorm_init(cfg.d_model, g.device),
        "out_proj": L.dense_init(g, cfg.d_model, path_dim, scale=0.02 / cfg.d_model),
    })


def generator_config(full_100m: bool):
    """The example's backbone: the reduced deepseek-7b family with 2 layers,
    or 12 layers of width 768 (~113M parameters, float32, scanned and
    rematerialised layers)."""
    base = get_config("deepseek-7b")
    if full_100m:
        return base.replace(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                            d_ff=3072, head_dim=64, vocab=256, scan_layers=True,
                            remat=True, compute_dtype="float32")
    return base.reduced().replace(n_layers=2)


def kernel_spec(dyadic: int):
    """One kernel spec shared by training and evaluation."""
    return dict(grid=GridConfig(lam1=dyadic, lam2=dyadic),
                transforms=TransformPipeline(time_aug=True), unbiased=False)


def train_loss(gen, step: int, batch: int, length: int, dim: int, dyadic: int):
    """The biased MMD² of one step's generated paths against its GBM targets
    (noise and targets drawn from generators seeded by the step)."""
    dev = next(gen.parameters()).device
    noise = torch.randn((batch, length, NOISE_DIM), device=dev,
                        generator=step_generator(2, step, dev))
    real = gbm_paths(step_generator(1, step, dev), batch, length, dim)
    return losses.mmd2(gen(noise), real, **kernel_spec(dyadic))


def eval_set(length: int, dim: int, device):
    """The fixed held-out evaluation set: 64 noise paths and 64 GBM paths."""
    noise = torch.randn((64, length, NOISE_DIM), device=device,
                        generator=step_generator(100, 0, device))
    return noise, gbm_paths(step_generator(101, 0, device), 64, length, dim)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--length", type=int, default=24)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="peak learning rate (the --full-100m generator at --length 256 "
                         "trains at 1e-5; see tools/gan_probe.py)")
    ap.add_argument("--full-100m", action="store_true",
                    help="~100M-param generator instead of the CPU-tiny one")
    ap.add_argument("--dyadic", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the plain versions)")
    args = ap.parse_args(argv)

    cfg = generator_config(args.full_100m)
    gen = build_generator(cfg, args.dim, NOISE_DIM, device=args.device)
    dev = next(gen.parameters()).device
    n_params = sum(p.numel() for p in gen.parameters())
    print(f"generator params: {n_params/1e6:.1f}M on {dev}")

    opt = AdamW(gen.parameters(), lr=cosine_schedule(args.lr, 20, args.steps),
                weight_decay=0.0)
    eval_noise, eval_real = eval_set(args.length, args.dim, dev)

    def eval_mmd():
        with torch.no_grad():
            return float(losses.mmd2(gen(eval_noise), eval_real, **kernel_spec(args.dyadic)))

    first = eval_mmd()
    print(f"initial eval sig-MMD^2: {first:.5f}")
    t0 = time.time()
    for step in range(args.steps):
        opt.zero_grad()
        loss = train_loss(gen, step, args.batch, args.length, args.dim, args.dyadic)
        loss.backward()
        gnorm = opt.step()["grad_norm"]
        if (step + 1) % args.log_every == 0:
            print(f"step {step+1:4d}  train MMD^2 {float(loss):.5f}  "
                  f"eval MMD^2 {eval_mmd():.5f}  gnorm {float(gnorm):.3f}  "
                  f"({(time.time()-t0)/(step+1)*1e3:.0f} ms/step)", flush=True)
    final = eval_mmd()
    print(f"eval MMD^2: {first:.5f} -> {final:.5f} "
          f"({'improved' if final < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
