"""The graph cache's bookkeeping (``tony_tpu_torch.models.graphs``), driven
on the CPU with a stand-in for ``torch.cuda.CUDAGraph``, and the paths
that replay through it held against the JAX package.

The stand-in (``StandIn``) keeps what a CUDA graph does to Python: a
capture runs the wrappers' Python but changes no state the caller
passed in (it runs the function once and puts back the static buffers
and whatever a ``functools.partial`` binds, the engine's cache among
them: a sampled call draws anew from keys the first call advanced, so
its writes differ), and a replay changes
state and fills the output but calls no wrapper (the launch counts a
replay's Python would add are taken back). Its capture runs under
``HostReadGuard``, which raises on any host read of a tensor, as the
card's capture fails on the sync such a read makes.

- Keys; the first call at a key runs eagerly on the key's buffers and
  its result is the call's; the launch-count delta of a capture is
  taken back and added on each replay; a capture error raises and
  leaves no entry, and so does a host read under the guard; the
  capture's entry calls are timed and put back.
- The ``Server`` through the stand-in: greedy streams equal the JAX
  ``Server``'s across slot re-admission (the key's buffers refilled on
  every replay); every chunk and prefill is a capture or a replay; a
  chunk with a sampled live row replays at its key's sampled variant;
  a capture error raises out of ``step``. Unpaged, chunks and verify rounds replay
  over the resident rows and prefills are eager calls.
- ``generate``'s per-slot step (the position on the device) equals the
  scalar-index step bit for bit (bf16 model, int8 weights, int8 KV
  cache); the replayed ``generate`` gives the JAX package's tokens, on
  fp32 and int8 weights, and replays a sampled call's steps at its own
  key, equal to the eager loop from the same generator state.

Tolerances: none; tokens and logits are compared for equality.
"""

import contextlib
import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from torch_parity import build_pair, tokens
from tony_tpu.models.generate import generate as jax_generate
from tony_tpu.models.quantize import quantize_for_serving as jax_qfs
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu_torch.models import quantize_for_serving
from tony_tpu_torch.models.convert import from_jax_params
from tony_tpu_torch.models.generate import (_generate_eager, generate,
                                            init_cache, single_decode_step)
from tony_tpu_torch.models.graphs import (CAPTURE_PARTS, GraphCache,
                                          _timed_entry, launch_counts,
                                          set_launch_counts)
from tony_tpu_torch.models.transformer import Transformer
from tony_tpu_torch.ops.decode import flash_decode
from tony_tpu_torch.ops.quant import q8_matmul
from tony_tpu_torch.serve import Request, Server


def _snapshot(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_snapshot(v) for v in x]
    return x


def _restore(x, saved):
    if isinstance(x, torch.Tensor):
        x.copy_(saved)
    elif isinstance(x, dict):
        for k in x:
            if isinstance(x[k], (torch.Tensor, dict, tuple, list)):
                _restore(x[k], saved[k])
            else:
                x[k] = saved[k]
    elif isinstance(x, (tuple, list)):
        for v, s in zip(x, saved):
            _restore(v, s)


class StandInGraph:
    def __init__(self, fn, statics, out):
        self.fn, self.statics, self.out = fn, statics, out

    def replay(self):
        counts = launch_counts()
        new = self.fn(*self.statics)
        set_launch_counts(counts)  # a replay calls no wrapper
        if new is not self.out:
            self.out.copy_(new)


class HostRead(RuntimeError):
    """A captured function read a tensor on the host."""


class HostReadGuard(TorchFunctionMode):
    """Raises on any host read of a tensor (``item``, ``tolist``,
    ``cpu``, ``numpy``, ``__bool__``, ``__int__``, ``__float__``,
    ``__index__``, ``__array__``): on the card each is a device sync,
    which breaks a capture, so a CPU run under this guard fails where
    the capture would."""

    READS = frozenset(("item", "tolist", "cpu", "numpy", "__bool__",
                       "__int__", "__float__", "__index__", "__array__"))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS:
            raise HostRead(f"host read of a tensor in a capture: {name}")
        return func(*args, **(kwargs or {}))


class StandIn:
    """``CudaGraphs``'s three methods on the CPU. A capture runs the
    function under ``HostReadGuard``."""

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.eager_runs = 0

    @contextlib.contextmanager
    def eager(self):
        self.eager_runs += 1
        yield

    def capture(self, fn, statics):
        # what the call may write: its static buffers and what a partial
        # binds (the engine's cache); all of it is put back
        state = (statics, (fn.args, fn.keywords)
                 if isinstance(fn, functools.partial) else ())
        saved = _snapshot(state)
        with HostReadGuard():
            out = fn(*statics)
        if self.fail:
            raise RuntimeError("stand-in capture failed")
        _restore(state, saved)
        return StandInGraph(fn, statics, out), out

    def pool_bytes(self):
        return 0


def _launching(x, y):
    """A toy call that 'launches' two flash-decode kernels and one q8
    decode-route kernel, as the wrappers count them."""
    flash_decode.launches += 2
    q8_matmul.launches += 1
    q8_matmul.route_launches[0] += 1
    y.add_(1)
    return x * 2 + y


def _counts():
    return (flash_decode.launches, q8_matmul.launches,
            list(q8_matmul.route_launches))


@pytest.fixture
def zeroed():
    saved = launch_counts()
    set_launch_counts([0] * len(saved))
    yield
    set_launch_counts(saved)


def test_first_call_eager_then_replays_count_launches(zeroed):
    backend = StandIn()
    g = GraphCache("cpu", backend)
    e = g.entry(("decode", 4), lambda: (torch.zeros(3), torch.zeros(3)))
    assert g.entry(("decode", 4), lambda: 1 / 0) is e
    x, y = e.statics
    x.copy_(torch.tensor([1.0, 2.0, 3.0]))
    out = g.run(e, _launching)
    # the eager call's own result, its state change made once
    assert torch.equal(out, torch.tensor([3.0, 5.0, 7.0]))
    assert torch.equal(y, torch.ones(3))
    assert backend.eager_runs == 1 and e.graph is not None
    assert e.out is not out
    assert _counts() == (2, 1, [1, 0, 0])  # the capture's calls taken back
    assert e.delta[:2] == [2, 1]
    for i in range(3):
        x.fill_(float(i))
        got = g.run(e, lambda *a: pytest.fail("a replay runs no Python"))
        assert got is e.out
        assert torch.equal(got, torch.full((3,), 2.0 * i + 2 + i))
        assert _counts() == (2 + 2 * (i + 1), 1 + i + 1, [2 + i, 0, 0])
    assert backend.eager_runs == 1
    e2 = g.entry(("prefill", 4), lambda: (torch.zeros(3), torch.zeros(3)))
    g.run(e2, _launching)
    assert backend.eager_runs == 2 and len(g.entries) == 2
    assert g.counters(("decode", "prefill", "generate")) == {
        "decode_captures": 1, "decode_replays": 3, "decode_eager": 0,
        "prefill_captures": 1, "prefill_replays": 0, "prefill_eager": 0,
        "generate_captures": 0, "generate_replays": 0,
        "generate_eager": 0, "capture_s": g.capture_seconds}


def test_capture_error_raises_and_leaves_no_entry(zeroed):
    g = GraphCache("cpu", StandIn(fail=True))
    e = g.entry(("decode", 1), lambda: (torch.zeros(2), torch.zeros(2)))
    with pytest.raises(RuntimeError, match="stand-in capture failed"):
        g.run(e, _launching)
    assert g.entries == {}
    assert _counts() == (2, 1, [1, 0, 0])  # the eager call's launches only
    assert g.calls["decode", "captures"] == 0


def test_stand_in_capture_refuses_host_reads(zeroed):
    """A function that reads a tensor on the host fails its capture, as
    it would on the card, and leaves no entry; its first call (eager)
    ran."""
    g = GraphCache("cpu", StandIn())
    for read in (lambda x: x.sum().item(), lambda x: bool(x.any()),
                 lambda x: x.tolist(), lambda x: int(x[0]),
                 lambda x: x.cpu()):
        e = g.entry(("decode", 1), lambda: (torch.ones(2),))
        with pytest.raises(HostRead):
            g.run(e, read)
        assert g.entries == {}


def test_capture_parts_are_timed_and_the_calls_restored():
    """``_timed_entry`` times the calls ``torch.cuda.graph`` makes on entry
    while it is held, and puts the real ones back after."""
    real = gc.collect
    parts = dict.fromkeys(CAPTURE_PARTS, 0.0)
    with _timed_entry(parts):
        assert gc.collect is not real
        gc.collect()
    assert gc.collect is real
    assert parts["gc"] > 0 and parts["sync"] == parts["empty_cache"] == 0


def test_eager_calls_are_counted(zeroed):
    g = GraphCache("cpu", StandIn())
    assert g.eager("decode", lambda a: a + 1, 2) == 3
    assert g.counters(("decode",))["decode_eager"] == 1


EOS = (9, 33, 71)
SERVE = dict(min_bucket=8, kv_page_size=8, prefix_cache_mb=4.0)


def _mix():
    """tests/test_torch_serve.py's mix: more requests than slots
    (re-admission at keys already captured), a shared preamble (partial
    prefix hits), an exact repeat, and requests that end on an eos id."""
    pre = tokens(10, 12).tolist()
    tails = [tokens(11 + i, n).tolist() for i, n in enumerate((3, 7, 5))]
    loose = [tokens(20 + i, n).tolist() for i, n in enumerate((4, 9, 2))]
    prompts = [pre + t for t in tails] + loose + [pre + tails[0]]
    return list(zip(prompts, [10, 6, 14, 8, 12, 1, 7]))


def _serve(srv, req_cls, temps=None):
    out = {}
    for i, (p, n) in enumerate(_mix()):
        t = 0.0 if temps is None else temps[i]
        srv.submit(req_cls(list(p), n, temperature=t, seed=i, id=i))
    while not srv.done:
        for r in srv.step():
            out[r.id] = (r.tokens, r.finish_reason)
    return out


@pytest.fixture(scope="module")
def models():
    return build_pair(9, decode_attention="flash")


@pytest.mark.parametrize("chunk_steps", [2, 8])
def test_replayed_server_matches_jax(models, chunk_steps):
    jm, jp, tm = models
    want = _serve(JaxServer(jm, jp, batch_size=2, eos_id=EOS,
                            chunk_steps=chunk_steps, paged=True, **SERVE),
                  JaxRequest)
    srv = Server(tm, batch_size=2, eos_id=EOS, chunk_steps=chunk_steps,
                 device="cpu", **SERVE)
    srv.graphs = GraphCache("cpu", StandIn())
    got = _serve(srv, Request)
    assert got == want
    assert any(r == "eos" for _, r in got.values())
    c = srv.counters()
    assert c["graph_decode_eager"] == c["graph_prefill_eager"] == 0
    assert c["graph_decode_captures"] + c["graph_decode_replays"] \
        == c["dispatches"]
    assert c["graph_prefill_captures"] + c["graph_prefill_replays"] \
        == c["prefills"]
    assert c["graph_decode_replays"] > 0 and c["graph_prefill_replays"] > 0
    assert c["graph_decode_captures"] == len(
        [k for k in srv.graphs.entries if k[0] == "decode"])


def test_sampled_chunks_run_eagerly_and_are_counted(models):
    """A chunk with a live sampled row is no longer eager: it replays at
    its key's sampled variant, and the streams equal the eager
    server's."""
    _, _, tm = models
    temps = [0.0, 0.8, 0.0, 0.0, 0.0, 0.0, 0.0]
    want = _serve(Server(tm, batch_size=2, eos_id=EOS, chunk_steps=4,
                         device="cpu", **SERVE), Request, temps)
    srv = Server(tm, batch_size=2, eos_id=EOS, chunk_steps=4,
                 device="cpu", **SERVE)
    srv.graphs = GraphCache("cpu", StandIn())
    assert _serve(srv, Request, temps) == want
    c = srv.counters()
    assert c["graph_decode_eager"] == 0
    assert c["graph_decode_captures"] + c["graph_decode_replays"] \
        == c["dispatches"]
    assert c["graph_prefill_captures"] + c["graph_prefill_replays"] \
        == c["prefills"]
    assert any(k[-1] == "sampled" for k in srv.graphs.entries)


def test_server_capture_error_raises(models):
    _, _, tm = models
    srv = Server(tm, batch_size=2, eos_id=EOS, device="cpu", **SERVE)
    srv.graphs = GraphCache("cpu", StandIn(fail=True))
    srv.submit(Request(tokens(3, 5).tolist(), 4))
    with pytest.raises(RuntimeError, match="stand-in capture failed"):
        srv.step()


@pytest.mark.parametrize("option", [{}, {"speculate_k": 3}],
                         ids=["plain", "spec"])
def test_replayed_unpaged_server_matches_jax(models, option):
    """The unpaged ``Server`` through the stand-in: chunks replay at
    ``("chunk_rows", k)`` and verify rounds at ``("verify_rows", window,
    continuation steps)`` over the resident rows, every prefill is one
    eager ``prefill_rows`` call, and the streams equal the JAX unpaged
    ``Server``'s."""
    jm, jp, tm = models
    kw = dict(batch_size=2, eos_id=EOS, chunk_steps=4, paged=False,
              min_bucket=8, prefix_cache_mb=4.0, **option)
    want = _serve(JaxServer(jm, jp, **kw), JaxRequest)
    srv = Server(tm, device="cpu", **kw)
    srv.graphs = GraphCache("cpu", StandIn())
    got = _serve(srv, Request)
    assert got == want
    c = srv.counters()
    assert c["graph_chunk_rows_eager"] == c["graph_verify_rows_eager"] == 0
    assert c["graph_chunk_rows_captures"] + c["graph_chunk_rows_replays"] \
        == c["dispatches"] - c["spec_rounds"]
    assert c["graph_verify_rows_captures"] \
        + c["graph_verify_rows_replays"] == c["spec_rounds"]
    assert c["graph_prefill_rows_eager"] == c["prefills"] > 0
    assert all(k[0] in ("chunk_rows", "verify_rows")
               for k in srv.graphs.entries)
    if option:
        assert c["spec_rounds"] > 0
    else:
        assert c["graph_chunk_rows_replays"] > 0


def _bf16(tm):
    m = Transformer(dataclasses.replace(tm.cfg, dtype=torch.bfloat16),
                    device="cpu")
    m.load_state_dict(tm.state_dict())
    return m


def _int8(tm):
    return quantize_for_serving(tm)


def _int8_kv(tm):
    m = Transformer(dataclasses.replace(tm.cfg, kv_cache_quant=True),
                    device="cpu")
    m.load_state_dict(tm.state_dict())
    return m


@pytest.mark.parametrize("make", [_bf16, _int8, _int8_kv],
                         ids=["bf16", "int8_weights", "int8_kv"])
@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_device_position_step_bit_equal_to_scalar_step(make, attn):
    """Prefill, then 5 steps both ways from equal caches: the logits and
    every cache leaf equal bit for bit."""
    _, _, tm = build_pair(4, decode_attention=attn)
    model = make(tm)
    prompt = torch.as_tensor(tokens(6, (3, 9)))
    scalar, slot = init_cache(model, 3), init_cache(model, 3)
    with torch.no_grad():
        model(prompt, decode=True, cache=scalar)
        model(prompt, decode=True, cache=slot)
    feed = torch.as_tensor(tokens(7, (3, 5)))
    pos = torch.full((3,), 9, dtype=torch.long)
    for t in range(5):
        _, want = single_decode_step(model, scalar, feed[:, t])
        _, got = single_decode_step(model, slot, feed[:, t], positions=pos)
        pos += 1
        assert torch.equal(got, want), t
    for key, layer in scalar.items():
        for name, leaf in layer.items():
            if isinstance(leaf, torch.Tensor):
                assert torch.equal(slot[key][name], leaf), (key, name)


def _jax_int8(jm, jp):
    jqm, jqp = jax_qfs(jm, {"params": jp})
    return jqm, jqp["params"]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_replayed_generate_matches_jax(int8, zeroed):
    jm, jp, tm = build_pair(0, decode_attention="flash")
    if int8:
        jm, jp = _jax_int8(jm, jp)
        qcfg = dataclasses.replace(tm.cfg, quantized=True)
        tm = Transformer(qcfg, device="cpu")
        tm.load_state_dict(from_jax_params(
            jax.tree.map(np.asarray, {"params": jp}), qcfg))
    tm.graphs = GraphCache("cpu", StandIn())
    prompt = tokens(5, (2, 7))
    eos = (7, 11)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt),
                                   max_new_tokens=12, eos_id=eos))
    for call in range(2):
        got = generate(tm, prompt, max_new_tokens=12, eos_id=eos).numpy()
        np.testing.assert_array_equal(got, want)
        c = tm.graphs.counters(("generate",))
        assert c["generate_captures"] == 1
        assert c["generate_replays"] == 10 + 11 * call
    eager = _generate_eager(tm, torch.as_tensor(prompt), 12,
                            lambda x: torch.argmax(x, -1), eos).numpy()
    np.testing.assert_array_equal(eager, want)
    sampled = generate(tm, prompt, max_new_tokens=5, temperature=0.7,
                       generator=torch.Generator().manual_seed(0))
    c = tm.graphs.counters(("generate",))
    assert c["generate_eager"] == 0
    assert c["generate_captures"] == 2
    assert c["generate_replays"] == 21 + 3
    graphs, tm.graphs = tm.graphs, None
    again = generate(tm, prompt, max_new_tokens=5, temperature=0.7,
                     generator=torch.Generator().manual_seed(0))
    tm.graphs = graphs
    assert torch.equal(sampled, again)
