"""LM text-generation engine: static-batch continuous batching over a
shared KV cache.

The port of ``repro.serving.engine``: the *language-model* half of the
serving package (driven by ``launch.serve``), unrelated to the SpGEMM
tier in ``spgemm_service`` / ``pool``.

Slots hold independent requests; finished slots are refilled from the
queue each decode step (continuous batching). Prefill runs per request
into the slot's cache row (written in place); decode steps the whole
batch, idle slots included (token 0 at length 0), as the reference's
does, so idle slots count against a MoE layer's capacity. Greedy sampling
(argmax). The engine runs on its parameters' device, with the matmul
weights held once in the compute dtype (``lm.cast_weights``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Decoder


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (L,) int32
    max_new_tokens: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 4
    max_len: int = 256
    eos_token: int = -1           # -1: never stop early
    cache_dtype: str = "float32"


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Decoder,
                 serve_cfg: ServeConfig):
        self.cfg = cfg
        self.params = lm.cast_weights(params, cfg.compute_dtype)
        self.scfg = serve_cfg
        self.device = params.embed.device
        b, s = serve_cfg.batch_slots, serve_cfg.max_len
        self.caches = lm.init_caches(cfg, b, s,
                                     dtype=getattr(torch,
                                                   serve_cfg.cache_dtype),
                                     device=self.device)
        self._prefill = lm.make_prefill_step(cfg)
        self._decode = lm.make_decode_step(cfg)
        self.slot_req: List[Optional[Request]] = [None] * b
        self.slot_len = np.zeros(b, np.int64)
        self.slot_next = np.zeros(b, np.int64)
        self.queue: List[Request] = []

    def _prefill_one(self, params, caches, tokens, slot: int):
        """Prefill a single slot: slice its cache row, run, write back."""
        row = lm.slice_caches(caches, slot, 1)
        logits, row = self._prefill(params, row, tokens)
        caches = lm.update_caches(caches, row, slot)
        return logits[0], caches

    def submit(self, req: Request):
        self.queue.append(req)

    def _fill_slots(self):
        for i in range(self.scfg.batch_slots):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                       device=self.device)[None]
                logits, self.caches = self._prefill_one(
                    self.params, self.caches, toks, i)
                # As src/repro/serving/engine.py:81: the argmax of
                # logits[-1], a 0-d value of the (V,) row, is always 0, so
                # every request's first token is 0. Kept so both engines
                # emit the same tokens; the fault is the reference's.
                nxt = int(torch.argmax(logits[-1]))
                req.output.append(nxt)
                self.slot_req[i] = req
                self.slot_len[i] = len(req.prompt)
                self.slot_next[i] = nxt

    def step(self):
        """One continuous-batching iteration: refill + one decode step."""
        self._fill_slots()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        token = torch.as_tensor(self.slot_next.reshape(-1, 1),
                                device=self.device)
        lens = torch.as_tensor(self.slot_len, device=self.device)
        logits, self.caches = self._decode(self.params, self.caches, token,
                                           lens)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            self.slot_len[i] += 1
            tok = int(nxt[i])
            req.output.append(tok)
            self.slot_next[i] = tok
            hit_eos = (self.scfg.eos_token >= 0 and tok == self.scfg.eos_token)
            if (len(req.output) >= req.max_new_tokens or hit_eos
                    or self.slot_len[i] + 1 >= self.scfg.max_len):
                req.done = True
                self.slot_req[i] = None
                self.slot_len[i] = 0
                self.slot_next[i] = 0
        return True

    def run(self, requests: List[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
        return requests
