"""Step engine: paged-cache decode + per-request host bookkeeping
(counterpart of ``repro.serve.engine``).

`StepEngine` owns the device state (params or a staleness-bounded
`ParamReplica`, the paged KV pools, the last tokens) and exposes three
verbs: ``start`` (prefill + page allocation), ``step`` (one decode step for
every active slot) and ``finish`` (free pages and slot).  Admission policy,
queues and completion tracking live in `repro_torch.serve.scheduler`.

The decode step mirrors `repro_torch.models.transformer.decode_step` layer
for layer, with the dense cache update swapped for a page write and gather:

  * full attention gathers the whole page table, which with in-order pages
    reproduces the dense ``(R, T, K, hd)`` cache layout, so the step is
    bitwise the dense loop's per request when ``max_pages_per_seq *
    page_size`` equals the dense ``max_len``;
  * windowed layers gather only the ``ceil(window/ps) + 1`` live pages per
    request and run ``swa_attention.decode_attention`` with per-request
    positions and page-base offsets: on the card that is the K9 kernel at
    any gather width, one launch per layer per step; on the CPU its plain
    version.  (The reference takes its Pallas kernel only behind a
    ``use_kernel`` flag that its launcher never sets, and only when the
    gather is a multiple of 128 keys wide.)

Inactive slots write to the pool's scratch page and their rows are
positionally masked, so admission and eviction change no shapes.  The
device mirrors of the slot positions, page table and active mask are
uploaded as *copies* of the host arrays, once after any number of
admissions or evictions, so the host may change its arrays while the
device still reads the old ones.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import BLOCK_ATTN, FRONTEND_NONE, ArchConfig
from repro_torch.kernels.swa_attention import ops as SWA
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TF
from repro_torch.serve import paged_cache as PC
from repro_torch.serve.paged_cache import PagedCacheConfig, PageAllocator
from repro_torch.serve.replica import ParamReplica
from repro_torch.serve.sampling import SampleConfig, sample_tokens


def validate_paged_support(cfg: ArchConfig) -> int:
    """Paged serving supports uniform-window attention stacks; returns the
    (single) window size (0: full attention)."""
    if cfg.block_type != BLOCK_ATTN:
        raise NotImplementedError(
            f"paged serving needs an attention stack, got {cfg.block_type}")
    if cfg.frontend != FRONTEND_NONE:
        raise NotImplementedError("paged serving: token frontends only")
    windows = set(cfg.layer_window_sizes())
    if len(windows) != 1:
        raise NotImplementedError(
            f"paged serving needs a uniform window, got {sorted(windows)}")
    return windows.pop()


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def _attend_full(cfg, q, kp, vp, table, pos, positions, dt):
    """Full-table gather + masked-chunk attention (the parity path)."""
    r = q.shape[0]
    hd = cfg.resolved_head_dim
    nk = cfg.n_kv_heads
    keys = PC.gather_all(kp, table).to(dt)
    vals = PC.gather_all(vp, table).to(dt)
    k_pos = torch.arange(keys.shape[1], device=q.device)[None]
    k_pos = torch.where(k_pos <= pos[:, None], k_pos, -1)
    q5 = q.reshape(r, 1, nk, cfg.n_heads // nk, hd)
    out = L.masked_attn_chunk(q5, keys, vals, positions, k_pos, 0,
                              hd ** -0.5)
    return out.reshape(r, 1, cfg.n_heads, hd).to(dt)


def _attend_window(cfg, pcfg, q, kp, vp, table, pos, dt, *, window: int):
    """Windowed gather (live pages only) + sliding-window decode attention
    (K9 on a CUDA tensor, its plain version on a CPU one).  A row with no
    live key (an inactive slot) gets the mean of its values, where the
    masked-chunk path gives zeros: only active rows are meaningful."""
    r = q.shape[0]
    hd = cfg.resolved_head_dim
    nk = cfg.n_kv_heads
    start, n_win = PC.window_slots(pos, window, pcfg, table.shape[1])
    keys, base = PC.gather_window(kp, table, start, n_win)
    vals, _ = PC.gather_window(vp, table, start, n_win)
    q4 = q[:, 0].reshape(r, nk, cfg.n_heads // nk, hd)
    out = SWA.decode_attention(q4, keys.to(dt), vals.to(dt), pos, base,
                               window=window)
    return out.reshape(r, 1, cfg.n_heads, hd).to(dt)


def make_paged_decode_step(cfg: ArchConfig, pcfg: PagedCacheConfig, *,
                           window: int = 0,
                           sample: SampleConfig = SampleConfig(),
                           check_finite: bool = False):
    """``(params, k_pool, v_pool, tokens (R,), pos (R,) int32, table,
    active, gen=None) -> (tokens (R,), pos (R,), k_pool, v_pool)``: one
    decode step for all R request slots, the pools written
    in place.  ``pos`` comes back advanced for active slots.

    ``check_finite`` appends a per-slot ``finite`` (R,) bool output (all
    last-position logits finite), the quarantine signal."""
    ps = pcfg.page_size
    r, n_table = pcfg.max_requests, pcfg.max_pages_per_seq

    @torch.no_grad()
    def step(params, k_pool, v_pool, tokens, pos, table, active, gen=None):
        dev = tokens.device
        x = params["embed"][tokens.long()][:, None].to(L.COMPUTE_DTYPE)
        positions = pos.long()[:, None]
        cur_slot = torch.clamp(torch.div(pos.long(), ps,
                                         rounding_mode="floor"),
                               max=n_table - 1)
        rows = torch.arange(r, device=dev)
        page_idx = torch.where(active, table.long()[rows, cur_slot],
                               pcfg.scratch_page)
        offset = pos.long() % ps
        for i in range(cfg.n_layers):
            lp = T.tree_map(lambda a: a[i], params["layers"])
            kp, vp = k_pool[i], v_pool[i]
            dt = x.dtype
            y = L.rmsnorm(x, lp["ln_attn"], cfg.norm_eps)
            q, k, v = L.project_qkv(lp["attn"], cfg, y, positions)
            PC.write_token_kv(kp, k[:, 0], page_idx, offset)
            PC.write_token_kv(vp, v[:, 0], page_idx, offset)
            if window:
                out = _attend_window(cfg, pcfg, q, kp, vp, table, pos, dt,
                                     window=window)
            else:
                out = _attend_full(cfg, q, kp, vp, table, pos, positions, dt)
            x = x + torch.einsum("bshk,hkd->bsd", out,
                                 lp["attn"]["wo"].to(dt))
            y2 = L.rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
            if cfg.is_moe:
                x = x + MOE.moe_block(lp["moe"], cfg, y2)[0]
            else:
                x = x + L.mlp_block(lp["mlp"], y2)
        logits = TF.lm_logits(cfg, params, x)[:, -1, :]        # (R, V)
        pos_next = torch.where(active, pos + 1, pos)
        out = (sample_tokens(logits, sample, gen), pos_next, k_pool, v_pool)
        if check_finite:
            out += (torch.all(torch.isfinite(logits), dim=-1),)
        return out

    return step


def make_paged_prefill_step(cfg: ArchConfig, pcfg: PagedCacheConfig,
                            bucket_pages: int, *,
                            sample: SampleConfig = SampleConfig()):
    """One-request prefill for prompts padded to ``bucket_pages`` pages:
    ``(params, k_pool, v_pool, tokens (1, bucket), true_len, page_ids
    (bucket_pages,), gen=None) -> (token (1,), k_pool, v_pool)``, the
    pools written in place.

    Runs the training-path stack (`attn_stack` with ``collect_kv``) on the
    padded prompt (causal masking keeps real positions blind to the pad
    tail), writes the collected KV into the request's pages and reads the
    logits at the true last position."""
    ps = pcfg.page_size
    bucket = bucket_pages * ps

    @torch.no_grad()
    def prefill(params, k_pool, v_pool, tokens, true_len: int, page_ids,
                gen=None):
        x = TF.embed_input(cfg, params, {"tokens": tokens.long()})
        positions = torch.arange(bucket, device=x.device)
        x, _, (k_new, v_new) = TF.attn_stack(cfg, params["layers"], x,
                                             positions, collect_kv=True)
        nl = cfg.n_layers
        pid = page_ids.long()
        k_pool[:, pid] = k_new[:, 0].reshape(
            nl, bucket_pages, ps, *k_new.shape[3:]).to(k_pool.dtype)
        v_pool[:, pid] = v_new[:, 0].reshape(
            nl, bucket_pages, ps, *v_new.shape[3:]).to(v_pool.dtype)
        logits = TF.lm_logits(cfg, params,
                              x[:, true_len - 1:true_len])[:, -1, :]
        return sample_tokens(logits, sample, gen), k_pool, v_pool

    return prefill


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class StepEngine:
    """Device-state owner for continuous-batching serving.

    Host-side state (page tables, per-slot positions, the allocator) is
    numpy; it changes on admission and eviction, between steps.  Device
    state (pools, last tokens, advancing positions) stays on the device
    across the whole run: nothing returns to the host per token.  Each
    prefill is bracketed by timing marks (CUDA events on a card, so no
    sync); :meth:`prefill_seconds` reads them.
    """

    def __init__(self, cfg: ArchConfig, params, pcfg: PagedCacheConfig, *,
                 sample: SampleConfig = SampleConfig(),
                 replica: ParamReplica | None = None, seed: int = 0,
                 check_finite: bool = False):
        self.cfg, self.pcfg = cfg, pcfg
        self.window = validate_paged_support(cfg)
        self.sample = sample
        self.replica = replica
        self.check_finite = check_finite
        self._static_params = params
        self.device = params["embed"].device
        self.alloc = PageAllocator(pcfg)
        r, n_table = pcfg.max_requests, pcfg.max_pages_per_seq
        self.table = np.full((r, n_table), pcfg.scratch_page, np.int32)
        self.pos = np.zeros((r,), np.int32)
        self.active = np.zeros((r,), bool)
        self.slot_rid: list = [None] * r
        self._slot_of: dict = {}
        self.k_pool, self.v_pool = PC.init_page_pool(
            cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim, pcfg,
            self.device)
        self.tokens = torch.zeros((r,), dtype=torch.int32, device=self.device)
        self._upload()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._decode = make_paged_decode_step(
            cfg, pcfg, window=self.window, sample=sample,
            check_finite=check_finite)
        self._prefills: dict = {}
        self._finite = None           # (R,) device bools (check_finite only)
        self.steps = 0
        self._prefill_marks: dict = {}   # rid -> (start, end) marks

    def _upload(self) -> None:
        """Device copies of the membership arrays (``torch.tensor`` always
        copies, so the host arrays stay free to change)."""
        self._d_pos = torch.tensor(self.pos, device=self.device)
        self._d_table = torch.tensor(self.table, device=self.device)
        self._d_active = torch.tensor(self.active, device=self.device)
        self._dirty = False

    def _mark(self):
        """A timing mark: a recorded CUDA event on a card, else the host
        clock (CPU work is synchronous)."""
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def prefill_seconds(self) -> dict:
        """rid -> seconds from the start to the end of its (last) prefill
        on the device's stream; one sync on a card."""
        if self.device.type != "cuda":
            return {rid: b - a for rid, (a, b) in self._prefill_marks.items()}
        torch.cuda.synchronize(self.device)
        return {rid: a.elapsed_time(b) / 1e3
                for rid, (a, b) in self._prefill_marks.items()}

    # -- capacity ----------------------------------------------------------
    @property
    def active_count(self) -> int:
        return int(self.active.sum())

    def has_slot(self) -> bool:
        return self.active_count < self.pcfg.max_requests

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        total = prompt_len + max_new
        if total > self.pcfg.max_pages_per_seq * self.pcfg.page_size:
            raise ValueError(
                f"request of {total} tokens exceeds per-request capacity")
        return self.has_slot() and self.alloc.can_alloc(
            self.pcfg.pages_needed(total))

    # -- params (direct or via the staleness-bounded replica) --------------
    def _params(self):
        if self.replica is not None:
            return self.replica.serving_params()
        return self._static_params

    # -- verbs -------------------------------------------------------------
    def start(self, rid, prompt: np.ndarray, max_new: int) -> torch.Tensor:
        """Admit ``rid``: allocate pages + a slot, prefill, emit the first
        token (returned as a device (1,) tensor: no host sync)."""
        prompt = np.asarray(prompt, np.int32)
        s = int(prompt.shape[0])
        assert s >= 1 and max_new >= 1
        n_pages = self.pcfg.pages_needed(s + max_new)
        bucket_pages = self.pcfg.pages_needed(s)
        pages = self.alloc.alloc(rid, n_pages)
        if pages is None:
            raise RuntimeError("admitted without pages (check can_admit)")
        slot = int(np.flatnonzero(~self.active)[0])
        self.table[slot] = self.pcfg.scratch_page
        self.table[slot, :n_pages] = pages
        if bucket_pages not in self._prefills:
            self._prefills[bucket_pages] = make_paged_prefill_step(
                self.cfg, self.pcfg, bucket_pages, sample=self.sample)
        padded = np.zeros((1, bucket_pages * self.pcfg.page_size), np.int32)
        padded[0, :s] = prompt
        mark = self._mark()
        tok, self.k_pool, self.v_pool = self._prefills[bucket_pages](
            self._params(), self.k_pool, self.v_pool,
            torch.tensor(padded, device=self.device), s,
            torch.tensor(pages[:bucket_pages], device=self.device),
            self._gen)
        self._prefill_marks[rid] = (mark, self._mark())
        self.pos[slot] = s
        self.active[slot] = True
        self.slot_rid[slot] = rid
        self._slot_of[rid] = slot
        # out of place: the scheduler's step log holds the old tensor
        self.tokens = self.tokens.clone()
        self.tokens[slot] = tok[0]
        self._dirty = True
        return tok

    def step(self) -> torch.Tensor:
        """One decode step for every active slot; returns the (R,) device
        token tensor (row r is meaningful iff slot r is active)."""
        if self._dirty:
            # host pos mirrors device pos exactly (advanced below in
            # lockstep with the on-device advance), so one upload restores
            # all three arrays after any number of start/finish calls
            self._upload()
        gen = None if self.sample.is_greedy else self._gen
        out = self._decode(
            self._params(), self.k_pool, self.v_pool, self.tokens,
            self._d_pos, self._d_table, self._d_active, gen)
        if self.check_finite:
            toks, self._d_pos, self.k_pool, self.v_pool, self._finite = out
        else:
            toks, self._d_pos, self.k_pool, self.v_pool = out
        self.tokens = toks
        self.pos[self.active] += 1
        self.steps += 1
        return toks

    def nonfinite_rids(self) -> list:
        """Requests whose last decode hit non-finite logits (empty unless
        ``check_finite``): the scheduler's quarantine signal, and the one
        host sync the fault path pays."""
        if not self.check_finite or self._finite is None:
            return []
        flags = self._finite.cpu().numpy()
        return [self.slot_rid[s] for s in np.flatnonzero(self.active)
                if not flags[s] and self.slot_rid[s] is not None]

    def poison_kv(self, rid) -> None:
        """Fault injection: NaN the request's most recently written key.
        Every live query attends that position, so the next decode step's
        logits go NaN for this slot."""
        slot = self._slot_of[rid]
        pos = int(self.pos[slot])
        if pos < 1:
            return
        page = int(self.table[slot, (pos - 1) // self.pcfg.page_size])
        off = (pos - 1) % self.pcfg.page_size
        self.k_pool[:, page, off] = float("nan")

    def finish(self, rid) -> None:
        """Evict ``rid``: free its pages and slot."""
        slot = self._slot_of.pop(rid)
        self.alloc.free(rid)
        self.table[slot] = self.pcfg.scratch_page
        self.pos[slot] = 0
        self.active[slot] = False
        self.slot_rid[slot] = None
        self._dirty = True

    def slot_of(self, rid) -> int:
        return self._slot_of[rid]
