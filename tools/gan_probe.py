#!/usr/bin/env python3
"""Train the --full-100m generator of examples/train_sigkernel_gan_torch.py
on one CUDA card at chip_smoke's phase 12 sizes ((64, 256, 8) GBM targets,
time-aug, (λ, λ) = (1, 1), 30 steps of AdamW with a cosine schedule warming up
over 20) for several (out_proj initial scale, peak learning rate) pairs, and
print one JSON line a pair: the eval MMD² on the example's fixed set before,
every 5 steps and after, the training MMD², and the generated paths' largest
end value.  This is how phase 12's peak rate was chosen.

    python3 tools/gan_probe.py                    # the default pairs
    python3 tools/gan_probe.py 0.02,1e-3 0,1e-5   # scale,lr pairs
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

#: the JAX example's scale (0.02) and rate (1e-3), the port's scale
#: (0.02 / 768), and lower rates
PAIRS = ("0.02,1e-3", "2.604e-5,1e-3", "2.604e-5,1e-4", "2.604e-5,3e-5", "2.604e-5,1e-5",
         "0,1e-5")


def main(pairs) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.core import losses
    from repro_torch.kernels.signature import kernel as sig_kernel
    from repro_torch.kernels.sigkernel_pde import kernel
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamW, cosine_schedule
    if not torch.cuda.is_available():
        print("gan_probe: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cs.build_all((kernel, sig_kernel))
    ex = cs.load_gan_example()
    dev = torch.device("cuda")
    G = cs.GAN
    B, Lh, d, lam, steps = G["batch"], G["length"], G["dim"], G["dyadic"], G["steps"]
    spec = ex.kernel_spec(lam)
    cfg = ex.generator_config(True)
    for pair in pairs:
        scale, lr = map(float, pair.split(","))
        gen = ex.build_generator(cfg, d, ex.NOISE_DIM, device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        with torch.no_grad():
            gen.out_proj.copy_(L.dense_init(g, cfg.d_model, d, scale=scale))
        opt = AdamW(gen.parameters(), lr=cosine_schedule(lr, G["warmup"], steps),
                    weight_decay=0.0)
        eval_noise, eval_real = ex.eval_set(Lh, d, dev)

        def eval_mmd():
            with torch.no_grad():
                return float(losses.mmd2(gen(eval_noise), eval_real, **spec))

        evals, train, ends = [eval_mmd()], [], []
        for step in range(steps):
            opt.zero_grad()
            loss = ex.train_loss(gen, step, B, Lh, d, lam)
            loss.backward()
            opt.step()
            train.append(float(loss.detach()))
            if step % 5 == 4:
                evals.append(eval_mmd())
                with torch.no_grad():
                    ends.append(float(gen(eval_noise)[:, -1].abs().max()))
        print(json.dumps({"out_proj_scale": scale, "lr": lr, "eval_mmd2_every_5": evals,
                          "train_mmd2": train, "max_abs_end_every_5": ends,
                          "fell": evals[-1] < evals[0], "card": card}), flush=True)
        del gen, opt
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or PAIRS))
