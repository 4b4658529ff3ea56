"""Goodput attribution: an analytic roofline ledger for the serving path.

The PyTorch port's copy of ``tony_tpu/obs/goodput.py``.

ROADMAP item 4 says serving-scale decode sits at ~33% of HBM bandwidth
and that "the gap is dispatch overhead and fixed-shape slot waste" —
but until now nothing in the system could say where the other 67%
GOES: the dispatch timeline records wall-ms and tokens, counters like
``wasted_steps`` and ``compile_ms`` exist, and an operator had to
correlate them by hand. This module closes that loop with two pieces:

- ``CostModel``: bytes-moved and FLOPs estimates for every dispatch
  kind (``prefill`` / ``hit_admit`` / ``cow_admit`` / ``decode`` /
  ``verify``) computed from the model's dimensions, the measured
  KV-cache byte layout, and the LIVE shape knobs each dispatch ran
  with (chunk depth, occupancy, paged view extent). Stamped onto each
  ``DispatchRecord`` as ``est_bytes`` / ``est_flops``; with a
  peak-HBM-GB/s reference available (chip table or ``--hbm-gbps``)
  each record also gets a per-dispatch HBM-BW% and MFU estimate. CPU
  runs report bytes with ``utilization: null`` — an estimate against
  an unknown roofline would be a lie.
- the goodput LEDGER (``ledger()``): decompose a replica's wall clock
  into named buckets that sum to <= 1.0 — steady useful work per
  dispatch kind, compile time, bucket/view padding waste (the pow2
  program shape minus what was actually fed), ``wasted_steps``
  overshoot past a finish, rejected speculative-draft positions, and
  the idle/queue gap that is everything the engine never dispatched.
  The decomposition is EXACT against the timeline by construction:
  every steady record's duration is split by its own
  ``tokens``/``fed``/``work`` position counts (useful + padding +
  overshoot + rejected == steady ms per kind), and
  ``sum(fed - tokens)`` over decode+verify reproduces the engine's
  ``wasted_steps`` counter — the reconciliation tests pin both.

Estimates are deliberately simple upper-bound program models (the
compiled program's static read/write set, causal attention averaged),
documented per method — good enough to rank waste buckets and track a
regression, not a substitute for a profiler trace. Everything here is
stdlib only; torch is touched only inside ``detect_*``.
"""

from __future__ import annotations

import math
import os


def _floor6(v: float) -> float:
    """Fraction rounding that PRESERVES the sums-to-<=1 invariant:
    floor at 1e-6 — round-half-up could push a bucket sum a few 1e-7
    past 1.0 and turn the ledger's structural guarantee into a flake."""
    return math.floor(max(0.0, v) * 1e6) / 1e6


# card tables: peak dense bf16 FLOP/s and HBM bandwidth per card, keyed
# by substring of ``torch.cuda.get_device_name()``, lowercased, first
# match wins (the PCIe part before the SXM one). NVIDIA's H100 data
# sheet: SXM (HBM3) 989 TFLOP/s and 3.35 TB/s; PCIe (HBM2e) 756 TFLOP/s
# and 2.0 TB/s. Both assume the full power limit.
PEAK_BF16_TABLE = (
    ("h100 pcie", 756e12), ("h100 80gb hbm3", 989e12), ("h100 sxm", 989e12),
)

HBM_BW_TABLE = (
    ("h100 pcie", 2000e9), ("h100 80gb hbm3", 3350e9), ("h100 sxm", 3350e9),
)

# ledger bucket names; "useful.<kind>" buckets ride alongside these.
# host_tier is the migration bucket: device<->host page moves
# (spills, page-ins) and handoff scatters — real work, but not token
# work, so it must neither inflate useful_fraction nor hide in idle
WASTE_BUCKETS = ("compile", "padding", "overshoot", "spec_rejected",
                 "host_tier", "idle")

# dispatch kinds whose steady time lands in the host_tier bucket:
# tier spills/restores AND the role-split handoff's gather/scatter —
# all pure page migration; none of them land tokens a request keeps
_HOST_TIER_KINDS = ("host_spill", "host_page_in", "handoff_out",
                    "handoff_admit")


_DISCOVERED_NAMES: list | None = None


def _discovered_chip_names() -> list:
    """The card's name (``torch.cuda.get_device_name()``), memoized per
    process: the card does not change under a running process, and every
    ``Server`` construction resolves the roofline reference twice. Empty
    without CUDA."""
    global _DISCOVERED_NAMES
    if _DISCOVERED_NAMES is None:
        import torch

        _DISCOVERED_NAMES = [torch.cuda.get_device_name()] \
            if torch.cuda.is_available() else []
    return _DISCOVERED_NAMES


def chip_lookup(table) -> float:
    """Resolve a per-card constant from the card's name. 0.0 when
    unknown — CPU boxes and cards the table does not list must degrade
    to "no utilization estimate", never to a wrong one."""
    for name in _discovered_chip_names():
        low = str(name).lower()
        for key, val in table:
            if key in low:
                return val
    return 0.0


def detect_hbm_gbps() -> float:
    """Peak HBM bandwidth reference in GB/s (0.0 = unknown).
    ``TONY_HBM_GBPS`` overrides the chip table — the hook for hardware
    the table does not know."""
    env = os.environ.get("TONY_HBM_GBPS", "")
    if env:
        try:
            return max(0.0, float(env))
        except ValueError:
            pass
    return chip_lookup(HBM_BW_TABLE) / 1e9


def detect_peak_flops() -> float:
    """Peak bf16 FLOP/s reference (0.0 = unknown)."""
    return chip_lookup(PEAK_BF16_TABLE)


class CostModel:
    """Analytic bytes/FLOPs per dispatch, from numbers the engine
    already has: real parameter bytes/count from the param tree, the
    MEASURED per-token KV byte cost (cache row bytes / max_seq_len, or
    page bytes / page size — so int8-KV, GQA, and scan_layers layouts
    are priced from truth, not re-derived), and the attention
    dimensions from the config. All estimates model the COMPILED
    program's static read/write set: a fixed-shape decode step reads
    the whole ``[batch, view]`` cache buffer whether slots are live or
    not — which is exactly why the ledger's padding bucket exists.

    PER-CHIP contract: on a sharded replica the caller
    constructs this model with PER-CHIP quantities — ``param_bytes``/
    ``param_count`` summed from the actual shardings (replicated
    leaves whole), ``kv_token_bytes`` divided by the pool's kv-head
    shard count, ``n_heads`` the per-chip head count — while
    ``hbm_gbps``/``peak_flops`` stay the SINGLE-chip roofline. Pricing
    total mesh bytes against one chip's roofline would push HBM-BW%
    past 100% and permanently mask a goodput collapse;
    ``serve.Server.__init__`` owns the division (it has the
    shardings), this class stays pure arithmetic."""

    def __init__(self, *, param_bytes: int, param_count: int,
                 kv_token_bytes: float, n_heads: int, head_dim: int,
                 vocab_size: int, hbm_gbps: float = 0.0,
                 peak_flops: float = 0.0):
        self.param_bytes = int(param_bytes)
        self.param_count = int(param_count)
        self.kv_token_bytes = float(kv_token_bytes)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.vocab_size = int(vocab_size)
        self.hbm_gbps = float(hbm_gbps)
        self.peak_flops = float(peak_flops)

    # attention FLOPs for one query position against a ctx-token
    # window: QK^T + PV, 2 FLOPs per MAC each
    def _attn_flops(self, ctx: float) -> float:
        return 4.0 * self.n_heads * self.head_dim * max(0.0, ctx)

    def decode(self, depth: int, batch: int, view_tokens: int) -> tuple:
        """A chunked decode dispatch: ``depth`` micro-steps over the
        resident ``[batch]`` slots, each re-reading every parameter
        byte and the ``[batch, view_tokens]`` cache span (the paged
        view's live extent, or max_seq_len unpaged), writing one K/V
        token per slot per step. Returns ``(bytes, flops)``."""
        kv_read = batch * view_tokens * self.kv_token_bytes
        kv_write = batch * self.kv_token_bytes
        n_bytes = depth * (self.param_bytes + kv_read + kv_write)
        flops = depth * batch * (2.0 * self.param_count
                                 + self._attn_flops(view_tokens))
        return n_bytes, flops

    def verify(self, window: int, batch: int, view_tokens: int) -> tuple:
        """A speculative verify dispatch: ONE multi-token pass scores
        ``window`` positions for every slot — parameters are read once
        (the whole point of verification vs ``window`` micro-steps),
        attention spans the view per position."""
        kv_read = batch * view_tokens * self.kv_token_bytes
        kv_write = batch * window * self.kv_token_bytes
        n_bytes = self.param_bytes + kv_read + kv_write
        flops = batch * window * (2.0 * self.param_count
                                  + self._attn_flops(view_tokens))
        return n_bytes, flops

    def prefill(self, window: int, offset: int = 0,
                view_tokens: int = 0) -> tuple:
        """A (suffix) prefill admit: one batch-1 pass over a
        ``window``-token bucket at position ``offset``, causal
        attention averaged over the window (each position sees
        ``offset + i`` context tokens)."""
        ctx = view_tokens if view_tokens else offset + window
        n_bytes = (self.param_bytes
                   + ctx * self.kv_token_bytes          # row/view read
                   + window * self.kv_token_bytes       # K/V written
                   + 4.0 * self.vocab_size)             # logits out
        flops = window * (2.0 * self.param_count
                          + self._attn_flops(offset + window / 2.0))
        return n_bytes, flops

    def hit_admit(self, row_bytes: int) -> tuple:
        """Unpaged exact-prefix hit: the stored cache row is COPIED
        into the slot, then one ``[1, V]`` sample from stored logits —
        read + write of the row dominates."""
        n_bytes = 2.0 * row_bytes + 4.0 * self.vocab_size
        return n_bytes, 2.0 * self.vocab_size

    def cow_admit(self, fork_bytes: int = 0) -> tuple:
        """Paged exact hit: pages alias host-side; device work is the
        optional boundary-page CoW fork plus the ``[1, V]`` sample —
        the 14.8x-fewer-bytes admission extras.paged measured."""
        n_bytes = 2.0 * fork_bytes + 4.0 * self.vocab_size
        return n_bytes, 2.0 * self.vocab_size

    def host_move(self, n_bytes: float) -> tuple:
        """A page-content migration (host-tier spill/page-in, handoff
        gather/scatter): a pure copy — ``n_bytes`` moved, zero
        FLOPs."""
        return float(n_bytes), 0.0

    def utilization(self, n_bytes: float, flops: float,
                    dur_ms: float) -> tuple:
        """(hbm_bw_pct, mfu_pct) for a dispatch that moved ``n_bytes``
        and computed ``flops`` in ``dur_ms`` — ``None`` where no
        roofline reference is known (CPU runs report bytes with
        utilization null rather than a made-up percentage)."""
        if dur_ms <= 0:
            return None, None
        secs = dur_ms / 1e3
        bw = round(100.0 * n_bytes / (secs * self.hbm_gbps * 1e9), 2) \
            if self.hbm_gbps > 0 else None
        mfu = round(100.0 * flops / (secs * self.peak_flops), 2) \
            if self.peak_flops > 0 else None
        return bw, mfu


def ledger(summary: dict, wall_ms: float, *, hbm_gbps: float = 0.0,
           peak_flops: float = 0.0) -> dict:
    """The goodput ledger: fold an (extended) timeline summary — the
    per-kind aggregates ``DispatchTimeline.summary()`` returns, with
    the ``useful_ms``/``padding_ms``/``overshoot_ms``/``rejected_ms``
    splits — plus the replica's wall clock into named bucket FRACTIONS
    that sum to <= 1.0:

    - ``useful.<kind>`` — steady dispatch time weighted by the
      positions that landed tokens a request kept;
    - ``compile`` — first-call (compile / cache-load) dispatch time;
    - ``padding`` — pow2 bucket/view/batch-shape positions the program
      computed but nobody fed (empty slots, prefill bucket tails,
      verify window padding, and — under in-dispatch EOS — a finished
      slot's FROZEN re-emit positions, which write no KV and feed
      nothing): the fixed-shape-waste bucket;
    - ``overshoot`` — positions fed real work whose output was trimmed
      (chunk overshoot past EOS/budget, verify bonus past a finish):
      the ``wasted_steps`` counter, as time. Structurally 0 with
      in-dispatch EOS on — nonzero overshoot on a frozen
      engine means an accounting bug, which the reconciliation tests
      would catch;
    - ``spec_rejected`` — rejected speculative-draft positions;
    - ``idle`` — wall clock the engine never dispatched in (queue
      gaps, host scheduling, admission lulls).

    The denominator is ``max(wall_ms, total dispatch ms)`` so the sum
    is <= 1.0 STRUCTURALLY even under clock jitter. Per-kind HBM-BW%
    and MFU ride along when a roofline reference is known (None
    otherwise — the CPU contract)."""
    wall_ms = max(0.0, float(wall_ms))
    ms: dict[str, float] = {"compile": 0.0, "padding": 0.0,
                            "overshoot": 0.0, "spec_rejected": 0.0,
                            "host_tier": 0.0}
    kinds: dict[str, dict] = {}
    total_dispatch = 0.0
    for kind, agg in summary.items():
        total_dispatch += agg["ms"]
        if kind in _HOST_TIER_KINDS:
            # migration time is its own bucket: page moves keep the
            # engine busy without landing tokens, and filing them
            # under useful.<kind> would let tier churn masquerade as
            # goodput (compile time still goes to compile)
            ms["host_tier"] += agg["ms"] - agg.get("compile_ms", 0.0)
            ms["compile"] += agg.get("compile_ms", 0.0)
        else:
            ms[f"useful.{kind}"] = agg.get("useful_ms", 0.0)
            ms["compile"] += agg.get("compile_ms", 0.0)
            ms["padding"] += agg.get("padding_ms", 0.0)
            ms["overshoot"] += agg.get("overshoot_ms", 0.0)
            ms["spec_rejected"] += agg.get("rejected_ms", 0.0)
        # utilization pairs STEADY cost with STEADY time: a compile
        # record's bytes over a steady denominator would inflate the
        # estimate (or read past 100% on a short run)
        steady_ms = agg["ms"] - agg.get("compile_ms", 0.0)
        bw = mfu = None
        if steady_ms > 0:
            secs = steady_ms / 1e3
            if hbm_gbps > 0:
                bw = round(100.0 * agg.get("est_bytes_steady", 0.0)
                           / (secs * hbm_gbps * 1e9), 2)
            if peak_flops > 0:
                mfu = round(100.0 * agg.get("est_flops_steady", 0.0)
                            / (secs * peak_flops), 2)
        kinds[kind] = {
            "est_bytes": agg.get("est_bytes", 0.0),
            "est_flops": agg.get("est_flops", 0.0),
            "hbm_bw_pct": bw,
            "mfu_pct": mfu,
        }
    ms["idle"] = max(0.0, wall_ms - total_dispatch)
    # the bucket sum itself joins the denominator (mirroring
    # merge_ledgers): the summary's per-kind splits arrive ROUNDED to
    # 3 decimals, and their rounding excess — up to ~0.5 us per split
    # key — can push sum(ms) a hair past the wall clock on a short,
    # warm-cache run; the sums-<=1 invariant must hold structurally,
    # not up to rounding luck
    denom = max(wall_ms, total_dispatch, sum(ms.values()), 1e-9)
    buckets = {k: _floor6(v / denom) for k, v in ms.items()}
    waste = {k: buckets.get(k, 0.0) for k in WASTE_BUCKETS}
    largest = max(waste, key=waste.get) if waste else None
    return {
        "wall_ms": round(wall_ms, 3),
        "dispatch_ms": round(total_dispatch, 3),
        "buckets": buckets,
        "ms": {k: round(v, 3) for k, v in ms.items()},
        "largest_waste": largest,
        "useful_fraction": round(sum(
            v for k, v in buckets.items()
            if k.startswith("useful.")), 6),
        "utilization": kinds,
        "hbm_gbps": hbm_gbps if hbm_gbps > 0 else None,
    }


def merge_ledgers(ledgers: list[dict]) -> dict:
    """Fleet rollup: sum bucket milliseconds and wall clocks across
    replicas, recompute fractions — a replica that has been up twice
    as long weighs twice as much, which is what a fleet-level "where
    does the time go" means. Utilization blocks are dropped (they are
    per-replica rates; the fleet /debug/goodput report carries each
    replica's own)."""
    ledgers = [g for g in ledgers if g]
    if not ledgers:
        return {}
    wall = sum(g["wall_ms"] for g in ledgers)
    dispatch = sum(g["dispatch_ms"] for g in ledgers)
    ms: dict[str, float] = {}
    for g in ledgers:
        for k, v in g["ms"].items():
            ms[k] = ms.get(k, 0.0) + v
    # the bucket sum itself joins the denominator: per-replica ledgers
    # export ms ROUNDED to 3 decimals, and summed rounding drift can
    # push sum(ms) a few 1e-6 past max(wall, dispatch) — the sums-<=1
    # invariant must hold structurally, not up to rounding luck
    denom = max(wall, dispatch, sum(ms.values()), 1e-9)
    buckets = {k: _floor6(v / denom) for k, v in ms.items()}
    waste = {k: buckets.get(k, 0.0) for k in WASTE_BUCKETS}
    return {
        "wall_ms": round(wall, 3),
        "dispatch_ms": round(dispatch, 3),
        "buckets": buckets,
        "ms": {k: round(v, 3) for k, v in ms.items()},
        "largest_waste": max(waste, key=waste.get) if waste else None,
        "useful_fraction": round(sum(
            v for k, v in buckets.items()
            if k.startswith("useful.")), 6),
    }
