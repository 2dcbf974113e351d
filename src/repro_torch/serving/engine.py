"""Minimal batched LM serving engine: one prefill per request batch, then
step-locked greedy decode (port of ``repro.serving.engine``).

Request padding (left), EOS handling and per-request stop as in the JAX
package's engine.  The decode loop is eager: each step is
``lm.decode_step``'s launches, then one host read of the step's tokens
(the reference reads them every step too); the step time between those
reads is kept in ``step_s``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    generated: list[int] = field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, max_seq: int = 256,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.device = resolve_device(device)
        #: host seconds of the last ``generate``: the prefill up to its
        #: tokens on the host, then each decode step likewise
        self.step_s: list[float] = []

    @torch.no_grad()
    def generate(self, requests: list[Request]) -> list[Request]:
        """Run a batch of requests to completion (greedy; argmax ties go to
        the first index)."""
        cfg = self.cfg
        b = len(requests)
        prompt_len = max(len(r.prompt) for r in requests)
        toks = np.zeros((b, prompt_len), np.int32)
        for i, r in enumerate(requests):
            toks[i, prompt_len - len(r.prompt):] = r.prompt  # left-pad

        self.step_s = []
        t0 = time.perf_counter()
        cache = T.init_cache(cfg, batch=b, max_seq=self.max_seq, device=self.device)
        logits, cache = lm.prefill(
            self.params, cfg, {"tokens": torch.from_numpy(toks).to(self.device)}, cache)
        steps = max(r.max_new_tokens for r in requests)
        cur = torch.argmax(logits, -1).to(torch.int32)
        for _ in range(steps):
            host = cur.tolist()  # the step's one host sync
            t1 = time.perf_counter()
            self.step_s.append(t1 - t0)
            t0 = t1
            for i, r in enumerate(requests):
                if not r.done:
                    tok = host[i]
                    r.generated.append(tok)
                    if r.eos_id is not None and tok == r.eos_id:
                        r.done = True
                    if len(r.generated) >= r.max_new_tokens:
                        r.done = True
            if all(r.done for r in requests):
                break
            logits, cache = lm.decode_step(self.params, cfg, cur, cache)
            cur = torch.argmax(logits, -1).to(torch.int32)
        return requests
