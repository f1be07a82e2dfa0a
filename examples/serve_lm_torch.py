"""Serve a small LM with the PyTorch port: batched prefill, then greedy
decode with KV caches (and, for the hybrid family, the sliding-window ring
and the RG-LRU state; for the SSM family, mamba2-780m, the conv window and
the SSD state, O(1) in the context; for the encoder-decoder,
whisper-large-v3, stubbed audio frames through the encoder and each decoder
layer's cross K/V).

The PyTorch counterpart of ``examples/serve_lm.py``, with its flags and
defaults (the ``.reduced()`` config of ``--arch``, random parameters from a
seed); it runs on the card unless given ``--device cpu``.  Every family
builds; ``--arch internvl2-76b`` (vlm) serves text only, as the JAX example
does: it feeds no patch embeddings.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch recurrentgemma-2b --tokens 32
"""

import argparse
import time

import torch

from repro_torch.api import card_device
from repro_torch.models import build_model, get_config
from repro_torch.serve.step import compute_params, make_decode_step, make_prefill_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = card_device(args.device, "serve_lm_torch.py")

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, seed=0, device=dev)
    max_len = args.prompt_len + args.tokens
    params = compute_params(model)          # one compute-dtype copy for both steps
    prefill = make_prefill_step(model, max_len=max_len, params=params)
    decode = make_decode_step(model, params=params)

    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=g,
                           device=dev)
    batch = {"tokens": prompt}
    if cfg.family == "encdec":
        batch["frames"] = 0.1 * torch.randn((args.batch, cfg.n_audio_frames, cfg.d_model),
                                            generator=g, device=dev)

    t0 = time.time()
    with torch.inference_mode():
        logits, caches = prefill(batch)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        out = [nxt]
        for t in range(args.prompt_len, max_len - 1):
            nxt, _, caches = decode(caches, nxt, t)
            out.append(nxt)
        toks = torch.cat(out, dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"arch={args.arch} generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.0f} tok/s incl. first calls)")
    print("sample:", toks[0, :16].tolist())
    return toks


if __name__ == "__main__":
    main()
