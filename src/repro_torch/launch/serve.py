"""Serving launcher: batched prefill + greedy decode against an LM arch
config, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --batch 4 --prompt 4096 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --smoke --device cpu

It prints the prefill time, the decode rate and a sample, as the
reference's launcher (``repro.launch.serve``) does, and the butterfly count
of the (request, token) graph of prompts plus generations (the sGrapp
monitor of ``examples/serve_lm.py``).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..configs import get_arch
from ..core.butterfly import snapshot_count
from ..device import resolve_device
from ..models.transformer import LMConfig, TransformerLM, decode_step, init_lm_params, prefill

__all__ = ["ServeResult", "load_model", "make_prompts", "serve",
           "monitor_butterflies", "main"]


@dataclass
class ServeResult:
    """One serving run: the greedy tokens ``[B, gen]`` (the first from the
    prefill's logits), host seconds for the prefill and for the decode
    steps (each ended by a device synchronize), and the last logits of the
    prefill and of the final decode step."""

    tokens: np.ndarray
    prefill_s: float
    decode_s: float
    prefill_logits: torch.Tensor
    last_logits: torch.Tensor

    def decode_tok_s(self) -> float:
        """Tokens the decode steps produced per second of their time:
        ``B * (gen - 1)`` (the prefill's token is not theirs); NaN when
        there was no decode step."""
        b, gen = self.tokens.shape
        if gen < 2 or self.decode_s <= 0:
            return float("nan")
        return b * (gen - 1) / self.decode_s


def load_model(arch_id: str, *, smoke: bool = False, seed: int = 0,
               device=None) -> tuple[LMConfig, TransformerLM]:
    """An LM arch's config (full or smoke) and seeded random weights on
    ``device``."""
    arch = get_arch(arch_id)
    if arch.family != "lm":
        raise SystemExit("serve launcher drives LM archs")
    cfg = arch.smoke_config() if smoke else arch.full_config()
    return cfg, init_lm_params(cfg, seed=seed, device=resolve_device(device))


def make_prompts(cfg: LMConfig, batch: int, prompt: int, seed: int = 0
                 ) -> np.ndarray:
    """``[batch, prompt]`` token ids, uniform over the vocabulary, from
    numpy's generator (the reference launcher's prompts for the same
    seed)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, prompt))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model: TransformerLM, cfg: LMConfig, prompts: np.ndarray,
          gen: int) -> ServeResult:
    """Prefill ``prompts`` and decode greedily to ``gen`` tokens per
    sequence (``gen - 1`` decode steps after the prefill's token)."""
    device = model.embed.device
    toks_in = torch.as_tensor(prompts, dtype=torch.int64, device=device)
    max_len = prompts.shape[1] + gen
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(model, toks_in, cfg, max_len)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    first = logits
    toks = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
    out = [toks]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode_step(model, cache, toks, cfg)
        toks = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        out.append(toks)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return ServeResult(torch.stack(out, dim=1).cpu().numpy(), prefill_s,
                       decode_s, first, logits)


def monitor_butterflies(prompts: np.ndarray, generated: np.ndarray,
                        device=None) -> float:
    """Butterflies of the (request, token) bipartite graph of prompts plus
    generations, through ``snapshot_count`` on ``device``: padded lanes of
    a power-of-two capacity, token ids made compact (the sGrapp hook of
    ``examples/serve_lm.py``)."""
    dev = resolve_device(device)
    full = np.concatenate([prompts, generated], axis=1)
    b = full.shape[0]
    req = np.repeat(np.arange(b), full.shape[1])
    n = len(req)
    cap = 1 << int(np.ceil(np.log2(max(n, 1))))
    ei = np.zeros(cap, np.int32)
    ej = np.zeros(cap, np.int32)
    valid = np.zeros(cap, bool)
    ei[:n], valid[:n] = req, True
    ej[:n] = np.unique(full.reshape(-1), return_inverse=True)[1]
    return float(snapshot_count(torch.as_tensor(ei, device=dev),
                                torch.as_tensor(ej, device=dev),
                                torch.as_tensor(valid, device=dev),
                                n_i=b, n_j=cap))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, model = load_model(args.arch, smoke=args.smoke, seed=args.seed,
                            device=device)
    prompts = make_prompts(cfg, args.batch, args.prompt, args.seed)
    res = serve(model, cfg, prompts, args.gen)
    print(f"[serve] prefill {args.batch}x{args.prompt}: "
          f"{res.prefill_s * 1e3:.1f}ms")
    print(f"[serve] decode {args.gen - 1} steps: {res.decode_s * 1e3:.1f}ms "
          f"({res.decode_tok_s():.0f} tok/s)")
    print("[serve] sample:", res.tokens[0][:8])
    bf = monitor_butterflies(prompts, res.tokens, device)
    print(f"[serve] sGrapp monitor: {bf:.0f} butterflies in the (request, "
          f"token) graph -> co-generation density "
          f"{bf / max(res.tokens.size + prompts.size, 1):.2f} per emission")


if __name__ == "__main__":
    main()
