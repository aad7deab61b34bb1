"""Serving engine: continuous batching over the paged KV cache.

Request lifecycle: queue → prefill (fills the sequence's pages) →
decode rounds (batched across live sequences, one token each, greedy:
the argmax of the logits) → completion (pages released).  Admission makes the JAX package's
decisions: a request is admitted while fewer than ``max_batch``
sequences are live and the free pages now could hold its prompt plus
``max_new_tokens``.  That reserves nothing, so live sequences can still
exhaust the pool (``MemoryError``, ROADMAP C4); a request that no pool of
``n_pages`` could ever hold raises at ``submit`` instead of waiting
forever.  So does a request longer than the engine's ``max_seq`` (C5)
or than a learned position table (BERT4Rec, C12), whose rows past it
the JAX engine would read as NaN.

The cache of every sequence lives in the page pools that
``transformer.init_paged_cache`` gives, in ``cfg.dtype`` on the engine's
device, addressed by the pager's block tables: K and V, (L, NP, KVH,
PS, Dh) each, for GQA; the latent and the rope key, (L, NP, PS, ·), for
MLA (DeepSeek-V3).  The engine holds either pair as ``k_pool`` and
``v_pool``.  Prefill runs per request over its prompt and writes the
prompt's rows into its pages.  A decode round takes one ``pager.plan``
of the live sequences (insertion order), copies it to the device once,
and runs one batched decode step: every layer writes the new row at
position ``lengths - 1``; GQA then launches B8 (``kernels.paged_attn``)
once over all live sequences, MLA attends over its gathered latent
pages.  MoE layers route dropless in a decode round, with capacity at
prefill, as in the JAX package.  The JAX engine
decodes each sequence alone over a dense cache and keeps the pager as
bookkeeping only; the token streams and the pager's decisions are the
same.  The tokens a prefill or a round embeds are on the host already:
their span is taken there and handed to the decoder, which checks it
against the vocabulary without a read back from the device.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..models import transformer as tf
from .kv_cache import PagedKVCache


def _span(tokens: np.ndarray) -> "tuple[int, int] | None":
    """(lowest, highest) of host token ids, ``None`` if there are none."""
    return (int(tokens.min()), int(tokens.max())) if tokens.size else None


@dataclass
class Request:
    prompt: np.ndarray
    max_new_tokens: int = 16
    rid: int = field(default_factory=itertools.count().__next__)
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False


@dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 256
    page_size: int = 16
    n_pages: int = 512
    greedy: bool = True        # the JAX package's field; both engines are
                               # greedy and neither reads it


class ServeEngine:
    def __init__(self, params: tf.Params, cfg: tf.TransformerConfig,
                 ecfg: EngineConfig, device=None):
        dev = resolve_device(device)
        where = params["embed"]["table"].device
        if where.type != dev.type or (dev.index is not None
                                      and where != dev):
            raise ValueError(f"the weights are on {where}, the engine "
                             f"serves on {dev}")
        self.device = where
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.pager = PagedKVCache(
            ecfg.n_pages, ecfg.page_size,
            max_pages_per_seq=ecfg.max_seq // ecfg.page_size)
        self.k_pool, self.v_pool = tf.init_paged_cache(
            cfg, ecfg.n_pages, ecfg.page_size, device=self.device)
        self.queue: list[Request] = []
        self.live: dict[int, Request] = {}   # rid → request, admitted order

    # -- API -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new_tokens
        if total > self.ecfg.max_seq:
            raise ValueError(f"request {req.rid}: {total} tokens exceed "
                             f"max_seq {self.ecfg.max_seq}")
        if self.cfg.learned_pos and total > self.cfg.max_seq:
            raise ValueError(f"request {req.rid}: {total} tokens exceed "
                             f"the {self.cfg.max_seq} learned positions "
                             f"of {self.cfg.name}")
        need = self._pages(total)
        if need > self.ecfg.n_pages:
            raise MemoryError(f"request {req.rid} needs {need} pages; the "
                              f"pool has {self.ecfg.n_pages}")
        self.queue.append(req)

    def run(self) -> list[Request]:
        done: list[Request] = []
        while self.queue or self.live:
            self._admit()
            self._decode_round()
            done.extend(self._collect())
        return done

    # -- internals ---------------------------------------------------------
    def _pages(self, tokens: int) -> int:
        return (tokens + self.ecfg.page_size - 1) // self.ecfg.page_size

    def _admit(self) -> None:
        while self.queue and len(self.live) < self.ecfg.max_batch:
            req = self.queue[0]
            pages_needed = self._pages(len(req.prompt) + req.max_new_tokens)
            if pages_needed > len(self.pager.free_pages):
                break                        # admission control
            self.queue.pop(0)
            pages = self.pager.allocate(req.rid, len(req.prompt))
            host = np.asarray(req.prompt, np.int64)[None, :]
            prompt = torch.from_numpy(host).to(self.device)
            with torch.no_grad():
                logits = tf.prefill_paged(
                    self.params, self.cfg, prompt, self.k_pool, self.v_pool,
                    torch.tensor(pages, device=self.device),
                    token_span=_span(host))
            req.out_tokens.append(int(torch.argmax(logits[0])))
            self.pager.extend(req.rid)
            self.live[req.rid] = req

    def _decode_round(self) -> None:
        if not self.live:
            return
        rids = list(self.live)
        table, lens = self.pager.plan(rids)       # lens == pos + 1
        tokens = np.array([self.live[r].out_tokens[-1] for r in rids],
                          np.int32)
        b, pmax = table.shape
        plan = torch.from_numpy(np.concatenate(
            [table.reshape(-1), lens, tokens])).to(self.device)
        block_table = plan[:b * pmax].view(b, pmax)
        seq_lens = plan[b * pmax:b * pmax + b]
        with torch.no_grad():
            logits = tf.decode_paged(
                self.params, self.cfg, self.k_pool, self.v_pool,
                plan[b * pmax + b:], seq_lens - 1, block_table, seq_lens,
                token_span=_span(tokens))
        for rid, nxt in zip(rids, torch.argmax(logits, dim=-1).tolist()):
            req = self.live[rid]
            req.out_tokens.append(nxt)
            self.pager.extend(rid)
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True

    def _collect(self) -> list[Request]:
        done = []
        for rid in [r for r, req in self.live.items() if req.done]:
            self.pager.release(rid)
            done.append(self.live.pop(rid))
        return done
