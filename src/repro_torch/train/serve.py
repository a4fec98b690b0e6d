"""Single-replica serving backend: prefill + a greedy decode loop over KV
and SSM caches (the port of ``src/repro/train/serve.py``).

``LMServer`` is the *compute* half of serving: greedy decoding over a batch
of requests of one prompt length, one replica, no scheduling.  The
continuous-batching, straggler-tolerant engine in :mod:`repro_torch.serve`
calls the same ``_prefill`` entry point per request and layers admission
control and coded-prefill SLO policies on top (DESIGN.md §9).

Termination is per-request: a row stops at its ``eos_id``, at its own
``max_new_per_request`` budget, or at the global ``max_new_tokens`` cap;
finished rows emit ``pad_id`` while the rest of the batch keeps decoding.

PyTorch has no ``lax.scan``, so the decode loop is the JAX package's
Python-level loop (``_python_generate``): tokens stay on the device and
reach the host once, at the end.  The model's ``prefill`` and
``decode_step`` run under ``torch.inference_mode()``; on the card the
prefill runs the flash-attention kernel in its attention layers and the SSD
kernel in its mamba layers.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.models.lm import LM, Cache, Params

__all__ = ["LMServer"]

_NO_EOS = -1  # sentinel: token ids are >= 0, so -1 never matches


class LMServer:
    """One replica's serving surface.

    Args:
      model: a decode-capable :class:`~repro_torch.models.lm.LM`.
      max_cache_len: hard cap on the decode cache length (the "model max
        sequence length" for serving purposes).  ``generate`` clamps its
        default ``cache_len = S + max_new_tokens`` to this and truncates the
        decode budget accordingly instead of overrunning the cache.
    """

    def __init__(self, model: LM, max_cache_len: int | None = None):
        if model.cfg.encoder_only:
            raise ValueError(f"{model.cfg.name} is encoder-only; no decode step")
        self.model = model
        self.max_cache_len = max_cache_len
        self._prefill = model.prefill
        self._decode = model.decode_step

    # -- cache-length policy -------------------------------------------------

    def _needs_full_cache(self) -> bool:
        """True when some layer keeps a full-length KV cache (positions may
        not exceed ``cache_len``).  SSM state is O(1) and never overruns."""
        return (
            any(spec.mixer == "attn" for spec in self.model.plan)
            and self.model.cfg.window is None
        )

    def resolve_lengths(
        self, S: int, max_new_tokens: int, cache_len: int | None
    ) -> tuple[int, int]:
        """(cache_len, decode_steps) with the cache-overrun guard applied."""
        if cache_len is None:
            cache_len = S + max_new_tokens
            if self.max_cache_len is not None:
                cache_len = min(cache_len, self.max_cache_len)
        if S > cache_len:
            raise ValueError(f"prompt length {S} exceeds cache_len {cache_len}")
        steps = max_new_tokens
        if self._needs_full_cache() and S + steps > cache_len:
            steps = cache_len - S
            warnings.warn(
                f"decode budget truncated to {steps} tokens: S={S} + "
                f"max_new_tokens={max_new_tokens} exceeds cache_len={cache_len}",
                RuntimeWarning,
                stacklevel=3,
            )
        return cache_len, steps

    # -- decode loop -----------------------------------------------------------

    def _python_generate(
        self, params: Params, logits0: torch.Tensor, cache: Cache,
        limits: torch.Tensor, eos_id: int, pad_id: int, steps: int,
    ) -> torch.Tensor:
        """Greedy decode, one ``decode_step`` a token.  Tokens accumulate on
        the device; the caller takes them to the host once."""
        B = logits0.shape[0]
        tok = torch.argmax(logits0, dim=-1).to(torch.int32)[:, None]
        finished = torch.zeros((B,), dtype=torch.bool, device=tok.device)
        pad = torch.tensor(pad_id, dtype=torch.int32, device=tok.device)
        outs = []
        for i in range(steps):
            emit = torch.where(finished, pad, tok[:, 0])
            outs.append(emit)
            finished = finished | (emit == eos_id) | (limits <= i + 1)
            logits, cache = self._decode(params, tok, cache)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        if not outs:
            return torch.zeros((B, 0), dtype=torch.int32, device=tok.device)
        return torch.stack(outs, dim=1)

    # -- public API ------------------------------------------------------------

    def generate(
        self,
        params: Params,
        batch: dict,
        max_new_tokens: int,
        cache_len: int | None = None,
        *,
        eos_id: int | None = None,
        max_new_per_request: np.ndarray | None = None,
        pad_id: int | None = None,
    ) -> np.ndarray:
        """Greedy decode.  batch: the model's inputs, ``{"tokens": (B, S)}``
        and a vision model's ``"patches"`` (tensors or arrays; they are
        moved to the parameters' device).  Returns (B, max_new_tokens)
        int32; rows finished early (EOS or per-request budget) are
        right-padded with ``pad_id``.

        As in the JAX server, ``S`` and the default ``cache_len`` count the
        tokens alone; a vision prompt's patches also take cache rows, so
        its caller passes a ``cache_len`` that holds them (the prefill
        raises otherwise)."""
        dev = params["embed"].device
        inputs = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        B, S = inputs["tokens"].shape
        cache_len, steps = self.resolve_lengths(S, max_new_tokens, cache_len)
        pad = int(pad_id if pad_id is not None else (eos_id if eos_id is not None else 0))
        eos = int(eos_id) if eos_id is not None else _NO_EOS
        if max_new_per_request is None:
            limits = torch.full((B,), np.iinfo(np.int32).max, dtype=torch.int32, device=dev)
        else:
            limits = torch.as_tensor(np.asarray(max_new_per_request, np.int32), device=dev)
            if tuple(limits.shape) != (B,):
                raise ValueError(f"max_new_per_request shape {tuple(limits.shape)} != ({B},)")

        logits, cache = self._prefill(params, inputs, cache_len=cache_len)
        toks = self._python_generate(params, logits, cache, limits, eos, pad, steps)
        out = toks.cpu().numpy()
        if steps < max_new_tokens:  # cache-overrun truncation: pad the tail
            out = np.pad(out, ((0, 0), (0, max_new_tokens - steps)), constant_values=pad)
        return out
