"""Training driver: the train loop with fault tolerance, on one device.

Counterpart of ``repro/launch/train.py``, with its flags, defaults, printed
lines and semantics:
* atomic async checkpoints every ``--ckpt-every`` steps
  (:class:`repro_torch.checkpoint.CheckpointManager`), the last one written
  synchronously (where the last step's asynchronous save already holds the
  state, the driver waits for that write; the JAX driver writes the same
  state a second time);
* a SIGTERM preemption hook -> a final synchronous checkpoint, exit 0;
* a heartbeat file each step (``{"step", "time", "process"}``), read by
  ``python -m repro_torch.launch.watchdog``;
* stateless step-indexed data (``TokenLM.batch_at(step)``) -> exact resume
  from any checkpointed step;
* restore onto another device: a checkpoint written on the card restores
  on the CPU and back.

The one flag the JAX driver lacks is ``--device``: the card by default
(raising where CUDA is not available), ``--device cpu`` on request.
``--mesh host`` is the one device.  The ``pod`` and ``multipod`` meshes
(256 and 512 devices) are refused: one process cannot train on 256 cards.
The port lays its steps out over them in the dry run,
``python -m repro_torch.launch.dryrun``, on fake devices.

The port updates the parameters and the AdamW state in place, so a signal
handler that saved them could land in the middle of ``AdamW.step()`` and
write a torn state.  The handler only records the signal; the loop checks
it between steps, saves synchronously at the step count it has reached and
exits 0.  :func:`train` restores the SIGTERM handler it replaced however
it ends.

Usage (CPU smoke):
    python -m repro_torch.launch.train --arch deepseek-7b --reduced --steps 20 --device cpu
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time

import numpy as np
import torch

from ..api import card_device
from ..checkpoint.manager import CheckpointManager, process_index
from ..data.synthetic import TokenLM
from ..models import build_model, get_config
from ..models.params import tree_items
from ..optim.adamw import AdamW, cosine_schedule
from ..train.step import apply_param_dtype, make_train_step


def heartbeat(path: str, step: int):
    with open(path, "w") as f:
        json.dump({"step": step, "time": time.time(),
                   "process": process_index()}, f)


def schedule(lr: float, steps: int):
    """The training driver's learning-rate schedule: a warm-up of a tenth of the run
    (at most 100 steps), then a cosine decay to ``steps``."""
    return cosine_schedule(lr, min(100, steps // 10 + 1), steps)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", choices=["host", "pod", "multipod"],
                    default="host")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--sig-loss", action="store_true",
                    help="attach the signature-kernel auxiliary loss")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="the device to train on (default the card; 'cpu' on request)")
    return ap


def train(argv=None):
    """Run the driver on ``argv`` (as ``main`` does) in this process and
    return ``(model, optimizer)`` as they stand after the last step.  A
    SIGTERM ends it through ``SystemExit(0)`` after the preemption
    checkpoint."""
    args = parser().parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: training over a mesh of 256 or 512 devices has no "
            "counterpart in one process; its layout, per-device bytes, flops and collectives "
            f"come from the dry run: python -m repro_torch.launch.dryrun --arch {args.arch} "
            f"--shape train_4k{' --multipod' if args.mesh == 'multipod' else ''}; train "
            "with --mesh host")
    dev = card_device(args.device, "repro_torch.launch.train")

    signals = []
    previous = signal.signal(signal.SIGTERM, lambda signum, frame: signals.append(signum))
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        if args.sig_loss:
            cfg = cfg.replace(sig_loss=True)

        model = build_model(cfg, seed=0, device=dev)
        with torch.no_grad():
            cast = apply_param_dtype(model.tree(), cfg)
            for (_, p), (_, c) in zip(tree_items(model.tree()), tree_items(cast)):
                p.data = c
            del cast
        opt = AdamW(model.parameters(), lr=schedule(args.lr, args.steps),
                    moment_dtype=cfg.moment_dtype)

        data = TokenLM(vocab=cfg.vocab, seq=args.seq, batch=args.batch,
                       n_patches=cfg.n_patches if cfg.family == "vlm" else 0,
                       n_frames=cfg.n_audio_frames if cfg.family == "encdec" else 0,
                       d_model=cfg.d_model,
                       sig_target_dim=cfg.sig_loss_dim if cfg.sig_loss else 0,
                       device=dev)
        step_fn = make_train_step(model, opt, num_microbatches=args.microbatches)

        def state():
            params = model.tree()
            return params, opt.state_tree(params)

        ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

        def save_now(at):
            """A synchronous checkpoint labelled ``at``: the write in flight
            finishes first, and where it holds this very state (the last
            step's asynchronous save) it is the checkpoint."""
            ckpt.wait()
            if not ckpt.latest_step() == at == step:
                ckpt.save(at, state(), blocking=True)

        step = 0
        if ckpt and ckpt.latest_step() is not None:
            s = ckpt.latest_step()
            (params, opt_state), _ = ckpt.restore(s, state(), device=dev)
            with torch.no_grad():
                for (_, p), (_, v) in zip(tree_items(model.tree()), tree_items(params)):
                    p.copy_(v)
            opt.load_state_tree(model.tree(), opt_state)
            del params, opt_state
            step = s
            print(f"resumed from step {s}")

        t_last, losses = time.time(), []
        while step < args.steps and not signals:
            metrics = step_fn(data.batch_at(step))
            losses.append(metrics["loss"])
            if args.heartbeat:
                heartbeat(args.heartbeat, step)
            if (step + 1) % args.log_every == 0:
                losses = [float(x) for x in losses]
                dt = time.time() - t_last
                print(f"step {step+1:5d}  loss {np.mean(losses):.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"{dt/args.log_every*1e3:.0f} ms/step", flush=True)
                t_last, losses = time.time(), []
            step += 1
            if ckpt and step % args.ckpt_every == 0:
                ckpt.save(step, state())
        if signals:
            print(f"signal {signals[0]}: writing preemption checkpoint", flush=True)
            if ckpt:
                save_now(step)
            sys.exit(0)
        if ckpt:
            save_now(args.steps)
    finally:
        signal.signal(signal.SIGTERM, previous)
    print("done")
    return model, opt


def main(argv=None):
    train(argv)


if __name__ == "__main__":
    main()
