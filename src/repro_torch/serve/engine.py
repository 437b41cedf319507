"""Slot-based continuous-batching LM serving engine (counterpart of
``repro.serve.engine``).

A fixed decode batch of ``slots`` runs every step; requests stream in and
out of slots without stopping the batch:

* admit: a free slot gets the next request: its prompt is prefilled with
  batch 1 and the caches are written into the slot's batch row;
* step: one decode step advances all slots (free slots decode garbage
  that is never read);
* retire: a slot whose request hit EOS, its ``max_new_tokens`` or a full
  cache frees at once.

Everything runs under ``torch.inference_mode()`` on the engine's device
(``cuda`` unless the caller passes another).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.device import check_on, resolve_device
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            init_cache, prefill)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4
    cache_len: int = 256


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig, serve_cfg: ServeConfig, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        check_on(self.device, params=T.leaves(params)[0])
        self.params = params
        self.cfg = cfg
        self.scfg = serve_cfg
        b = serve_cfg.slots
        self.caches = init_cache(cfg, b, serve_cfg.cache_len,
                                 device=self.device)
        self.pos = np.zeros((b,), np.int64)
        self.last_tok = np.zeros((b,), np.int64)
        self.active: list[Request | None] = [None] * b
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []
        self.steps = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _write_slot(self, slot: int, slot_caches) -> None:
        """Write a batch-1 cache tree into batch row ``slot``, in place
        (the engine owns its caches).  The batch axis is the first axis
        whose extent differs between the two trees (period leaves lead
        with the period axis); with one slot no axis differs and the
        whole leaf is replaced, as JAX's ``dynamic_update_slice`` at 0
        does."""
        def write(full, one):
            for ax in range(full.dim()):
                if full.shape[ax] != one.shape[ax]:
                    full.narrow(ax, slot, 1).copy_(one)
                    return full
            full.copy_(one)
            return full
        self.caches = T.tree_map(write, self.caches, slot_caches)

    def _admit(self) -> None:
        for slot in range(self.scfg.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)[None]
            logits, caches1 = prefill(self.params, self.cfg, prompt,
                                      cache_len=self.scfg.cache_len)
            tok = int(logits[0].argmax(-1))
            req.output.append(tok)
            self._write_slot(slot, caches1)
            self.pos[slot] = len(req.prompt)
            self.last_tok[slot] = tok
            self.active[slot] = req

    def _retire(self, slot: int) -> None:
        req = self.active[slot]
        req.done = True
        self.completed.append(req)
        self.active[slot] = None

    @torch.inference_mode()
    def step(self) -> int:
        """Admit + one decode step for all active slots (counted in
        ``steps``).  Returns the number of active requests after the
        step."""
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        logits, self.caches = decode_step(
            self.params, self.cfg,
            torch.as_tensor(self.last_tok, device=self.device), self.caches,
            torch.as_tensor(self.pos, device=self.device))
        self.steps += 1
        toks = logits.argmax(-1).tolist()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = toks[slot]
            req.output.append(tok)
            self.pos[slot] += 1
            self.last_tok[slot] = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            full = self.pos[slot] + 1 >= self.scfg.cache_len
            if len(req.output) >= req.max_new_tokens or hit_eos or full:
                self._retire(slot)
        return sum(r is not None for r in self.active)

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self.queue or any(r is not None for r in self.active)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.completed
