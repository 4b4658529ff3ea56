"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import no JAX, so they run on a GPU machine without
it; with no CUDA device they skip (a CUDA kernel has no CPU mode):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerance, per output element: |got - want| <= rtol * |want| + atol,
with atol = 1e-5 * max|v| (both sum in fp32, in a different order) and,
for a bf16 output, rtol = 2^-7 (the fp32 results may round to
neighbouring bf16 values, one bf16 step of the element apart); rtol = 0
for an fp32 output.
"""

import pytest
import torch

from tony_tpu_torch.ops import decode as dec
from tony_tpu_torch.ops.decode import (flash_decode, flash_decode_reference,
                                       quantize_kv)


def _assert_close(got, want, vmax):
    rtol = 0.0 if want.dtype == torch.float32 else 2.0 ** -7
    diff = (got.float() - want.float()).abs()
    excess = (diff - rtol * want.float().abs()).max().item()
    assert excess <= 1e-5 * vmax, (excess, diff.max().item(), rtol, vmax)


def _inputs(b, s, h, kvh, d, cache, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, d, device="cuda", generator=g)
    k = torch.randn(b, s, kvh, d, device="cuda", generator=g)
    v = torch.randn(b, s, kvh, d, device="cuda", generator=g)
    vmax = v.abs().max().item()
    dt = torch.float32 if cache == "fp32" else torch.bfloat16
    q = q.to(dt)
    if cache == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        return q, k, v, dict(k_scale=ks, v_scale=vs), vmax
    return q, k.to(dt), v.to(dt), {}, vmax


# bf16 and int8 caches under a bf16 q take the tensor-core route (G = 1,
# 6, 8 in one block of 16 query rows, G = 20 in two); fp32 the SIMT one
@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("heads", [(12, 2), (12, 12), (8, 1), (20, 1)])
@pytest.mark.parametrize("s,window", [(300, 0), (300, 50), (64, 0),
                                      (1027, 0), (1027, 300)])
def test_flash_decode_kernel_matches_plain_version(cache, heads, s, window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    h, kvh = heads
    q, k, v, kw, vmax = _inputs(8, s, h, kvh, 128, cache)
    length = torch.tensor([0, 1, 63, 64, 65, s // 2, s - 1, s],
                          dtype=torch.int32, device="cuda")
    before = flash_decode.launches
    got = flash_decode(q, k, v, length, window=window, **kw)
    want = flash_decode_reference(q, k, v, length, window=window, **kw)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert dec.plan(q, k, window)[0] == (cache != "fp32")
    assert torch.isfinite(got).all()
    assert (got[0] == 0).all()  # length 0: exact zeros
    _assert_close(got, want, vmax)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("d,tc", [(64, True), (128, True), (96, False)])
@pytest.mark.parametrize("heads", [(12, 2), (4, 4), (16, 2)])
def test_flash_decode_routes_by_head_dim(cache, d, tc, heads):
    """A bf16 q at D = 64 or 128 takes the tensor-core route, at another
    head dim the SIMT one; both meet the limit, lengths out of range are
    clamped by the kernels as the plain version masks them, and a second
    run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, kvh = heads
    s = 200
    q, k, v, kw, vmax = _inputs(4, s, h, kvh, d, cache, seed=2)
    length = torch.tensor([-3, 1, 131, s + 9], dtype=torch.int32,
                          device="cuda")
    assert dec.plan(q, k)[0] == tc
    got = flash_decode(q, k, v, length, **kw)
    again = flash_decode(q, k, v, length, **kw)
    want = flash_decode_reference(q, k, v, length, **kw)
    torch.cuda.synchronize()
    assert (got[0] == 0).all()  # a negative length sees no key
    _assert_close(got, want, vmax)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("s,window", [(300, 0), (4096, 0), (1024, 48),
                                      (64, 0)])
@pytest.mark.parametrize("heads", [(12, 2), (20, 1), (6, 6)])
def test_flash_decode_kernel_writes_only_its_outputs(cache, s, window,
                                                     heads):
    """Out-of-bounds writes: the C entry point gets the output and the
    split-KV scratch as windows into larger buffers filled with a canary
    on both sides. The canaries must survive, the inputs must be left
    as they were, and the result must equal the wrapper's bit for bit
    (S = 64 takes one split: the kernel writes the output itself)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, kvh = heads
    d, b = 128, 8
    q, k, v, kw, _ = _inputs(b, s, h, kvh, d, cache, seed=1)
    length = torch.tensor([0, 1, 63, 64, 65, s // 2, s - 1, s],
                          dtype=torch.int32, device="cuda")
    inputs = [q, k, v, length] + list(kw.values())
    before = [t.clone() for t in inputs]
    want = flash_decode(q, k, v, length, window=window, **kw)
    nsplit = dec.plan(q, k, window)[1]
    pad = 4096

    def guarded(n, dtype):
        buf = torch.full((pad + n + pad,), -7.25, dtype=dtype,
                         device="cuda")
        return buf, buf[pad:pad + n]

    out_buf, out = guarded(q.numel(), q.dtype)
    g = h // kvh
    ml_buf, ml = guarded(b * kvh * nsplit * g * 2, torch.float32)
    acc_buf, acc = guarded(b * kvh * nsplit * g * d, torch.float32)
    err = dec._kernel()(
        dec._DTYPE_CODES[k.dtype], dec._DTYPE_CODES[q.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(),
        kw["k_scale"].data_ptr() if kw else None,
        kw["v_scale"].data_ptr() if kw else None, length.data_ptr(),
        out.data_ptr(), ml.data_ptr(), acc.data_ptr(), b, h, kvh, s, d,
        window, float(d ** -0.5), nsplit,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for buf in (out_buf, ml_buf, acc_buf):
        assert (buf[:pad] == -7.25).all() and (buf[-pad:] == -7.25).all()
    assert all(torch.equal(a, c) for a, c in zip(inputs, before))
    assert torch.equal(out.view(q.shape), want)


@pytest.mark.cuda
def test_flash_decode_kernel_refuses_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v, _, _ = _inputs(2, 16, 4, 2, 128, "bf16")
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                     v, 8)
    with pytest.raises(ValueError, match="must match"):
        flash_decode(q.float(), k, v, 8)


# ------------------------------------------------------- flash attention
# Per element |got - want| <= the limit of ops.attention.error_bound:
# u times the element's sum of absolute products (u = 2^-7 bf16, 2^-14
# fp32), plus u |want|; lse to 1e-5 (1 + |lse|). Each backward kernel
# gets the same inputs (q, k, v, the kernel's o and lse, dO) as its
# plain version.

from tony_tpu_torch.ops import attention as att  # noqa: E402

ATT_CASES = [  # b, lq, lk, h, kvh, d, dtype, causal, window, segments
    (2, 300, 300, 12, 2, 128, torch.bfloat16, True, 0, False),
    (2, 300, 300, 12, 2, 128, torch.float32, True, 0, False),
    (2, 300, 300, 12, 2, 128, torch.bfloat16, True, 48, False),
    (2, 300, 300, 12, 2, 128, torch.float32, True, 0, True),
    (1, 127, 127, 6, 1, 128, torch.bfloat16, True, 0, True),
    (2, 200, 200, 4, 4, 64, torch.bfloat16, True, 0, False),
    (2, 96, 160, 4, 2, 64, torch.float32, False, 0, False),
    (1, 128, 256, 4, 2, 64, torch.float32, True, 0, False),
    # the bf16 tensor-core backward's edges: unequal lengths without the
    # causal mask, lengths off its 64-row tile, a window narrower than a
    # tile, GQA 6:1 and 8:1 and MHA, D 64 and 128, segments
    (2, 96, 160, 4, 2, 64, torch.bfloat16, False, 0, False),
    (1, 200, 129, 12, 2, 128, torch.bfloat16, False, 0, False),
    (1, 128, 256, 4, 2, 64, torch.bfloat16, True, 0, False),
    (2, 129, 129, 12, 2, 128, torch.bfloat16, True, 0, False),
    (1, 257, 257, 8, 1, 64, torch.bfloat16, True, 48, False),
    (2, 300, 300, 8, 1, 128, torch.bfloat16, True, 0, False),
    (2, 300, 300, 6, 6, 128, torch.bfloat16, True, 0, False),
    (2, 300, 300, 12, 2, 128, torch.bfloat16, True, 0, True),
    (1, 1024, 1024, 12, 2, 128, torch.bfloat16, True, 0, False),
]


def _att_inputs(b, lq, lk, h, kvh, d, dtype, segments, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, lq, h, d, device="cuda", generator=g).to(dtype)
    k = torch.randn(b, lk, kvh, d, device="cuda", generator=g).to(dtype)
    v = torch.randn(b, lk, kvh, d, device="cuda", generator=g).to(dtype)
    do = torch.randn(b, lq, h, d, device="cuda", generator=g).to(dtype)
    seg = None
    if segments:  # three packed documents a row
        cuts = torch.tensor([lq // 4, lq // 2 + 3], device="cuda")
        seg = (torch.arange(lq, device="cuda")[None, :, None]
               >= cuts[None, None, :]).sum(-1).to(torch.int32).expand(b, lq)
        seg = seg.contiguous()
    return q, k, v, do, seg


def _within(got, want, limit, name):
    diff = (got.float() - want.float()).abs()
    excess = (diff - limit).max().item()
    assert excess <= 0, (name, excess, diff.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATT_CASES)
def test_flash_attention_kernels_match_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, lq, lk, h, kvh, d, dtype, causal, window, segments = case
    q, k, v, do, seg = _att_inputs(b, lq, lk, h, kvh, d, dtype, segments)
    kw = dict(causal=causal, window=window, segment_ids=seg)
    inputs = [q, k, v, do] + ([seg] if seg is not None else [])
    before = [t.clone() for t in inputs]
    n0 = (att.flash_attention_fwd.launches,
          att.flash_attention_bwd_dq.launches,
          att.flash_attention_bwd_dkv.launches)
    o, lse = att.flash_attention_fwd(q, k, v, **kw)
    dq = att.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    dk, dv = att.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (att.flash_attention_fwd.launches,
            att.flash_attention_bwd_dq.launches,
            att.flash_attention_bwd_dkv.launches) == tuple(x + 1 for x in n0)
    assert all(torch.equal(a, c) for a, c in zip(inputs, before))
    o_ref, lse_ref = att.flash_attention_reference(q, k, v, causal, window,
                                                   seg, return_lse=True)
    grads = att.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    lim = att.error_bound(q, k, v, o_ref, lse_ref, do, **kw)
    lim_b = att.error_bound(q, k, v, o, lse, do, **kw)
    _within(o, o_ref, lim["o"], "o")
    _within(lse, lse_ref, 1e-5 * (1 + lse_ref.abs()), "lse")
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        assert torch.isfinite(got.float()).all()
        _within(got, want, lim_b[name], name)


@pytest.mark.cuda
def test_flash_attention_autograd_matches_plain_autograd():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v, do, seg = _att_inputs(2, 256, 256, 12, 2, 128, torch.float32,
                                   True)
    got, want = [], []
    for fn, out in ((att.flash_attention, got),
                    (att.flash_attention_reference, want)):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*x, causal=True, segment_ids=seg) * do).sum().backward()
        out.extend(t.grad for t in x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l", [(torch.float32, 131),
                                     (torch.bfloat16, 131),
                                     (torch.bfloat16, 300),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 1)])
def test_flash_attention_kernels_write_only_their_outputs(dtype, l):
    """Each kernel gets its outputs, and bf16 dK/dV its fp32 partial-sum
    scratch (the query group split as the wrapper splits it), as windows
    into larger buffers with a canary on both sides: the canaries survive
    and the results equal the wrappers' bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, h, kvh, d = 2, 12, 2, 128
    q, k, v, do, seg = _att_inputs(b, l, l, h, kvh, d, dtype, True, seed=3)
    kw = dict(causal=True, window=0)
    o, lse = att.flash_attention_fwd(q, k, v, segment_ids=seg, **kw)
    dq = att.flash_attention_bwd_dq(q, k, v, o, lse, do, segment_ids=seg,
                                    **kw)
    dk, dv = att.flash_attention_bwd_dkv(q, k, v, o, lse, do,
                                         segment_ids=seg, **kw)
    pad = 4096

    def guarded(like):
        buf = torch.full((pad + like.numel() + pad,), -7.25,
                         dtype=like.dtype, device="cuda")
        return buf, buf[pad:pad + like.numel()].view(like.shape)

    delta = att._delta(o, do)
    outs = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv)
    splits = 1
    if dtype == torch.bfloat16:
        splits = att.dkv_splits(b, l, kvh, h // kvh, q.device)
        assert splits > 1  # these grids are small: the scratch is used
        outs["part"] = torch.empty(2 * splits * k.numel(),
                                   dtype=torch.float32, device="cuda")
    bufs = {n: guarded(t) for n, t in outs.items()}
    att._launch(0, q, k, v, seg, out=bufs["o"][1], lse_out=bufs["lse"][1],
                **kw)
    att._launch(1, q, k, v, seg, do=do, lse=lse, delta=delta,
                dq=bufs["dq"][1], **kw)
    att._launch(2, q, k, v, seg, do=do, lse=lse, delta=delta,
                dk=bufs["dk"][1], dv=bufs["dv"][1],
                part=bufs["part"][1] if splits > 1 else None, splits=splits,
                **kw)
    torch.cuda.synchronize()
    for name, want in outs.items():
        buf, view = bufs[name]
        assert (buf[:pad] == -7.25).all() and (buf[-pad:] == -7.25).all()
        if name != "part":
            assert torch.equal(view, want), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (2, 300, 300, 12, 2, 128, True, 0, False),
    (2, 300, 300, 8, 1, 64, True, 48, False),
    (1, 200, 129, 6, 6, 128, False, 0, False),
    (2, 300, 300, 12, 2, 128, True, 0, True)])
def test_flash_attention_bf16_backward_is_bit_reproducible(case):
    """The bf16 dQ and dK/dV kernels (and dK/dV's partial pass) sum in a
    fixed order, with no atomics: two runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, lq, lk, h, kvh, d, causal, window, segments = case
    q, k, v, do, seg = _att_inputs(b, lq, lk, h, kvh, d, torch.bfloat16,
                                   segments, seed=4)
    kw = dict(causal=causal, window=window, segment_ids=seg)
    o, lse = att.flash_attention_fwd(q, k, v, **kw)
    runs = [(att.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw),
             *att.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [8, 4])
def test_flash_attention_bf16_backward_reads_strided_inputs(pad):
    """q, k, v and dO as views into wider rows: with 8 elements of padding
    the kernels read them through their strides (16-byte rows stay
    aligned), with 4 the wrapper copies them first; either way the
    results equal those of contiguous inputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, l, h, kvh, d = 2, 200, 12, 2, 128
    q, k, v, do, _ = _att_inputs(b, l, l, h, kvh, d, torch.bfloat16, False,
                                 seed=5)

    def strided(t):
        wide = torch.zeros(*t.shape[:3], d + pad, dtype=t.dtype,
                           device="cuda")
        wide[..., :d] = t
        return wide[..., :d]

    o, lse = att.flash_attention_fwd(q, k, v)
    want = (att.flash_attention_bwd_dq(q, k, v, o, lse, do),
            *att.flash_attention_bwd_dkv(q, k, v, o, lse, do))
    sq, sk, sv, sdo = (strided(t) for t in (q, k, v, do))
    got = (att.flash_attention_bwd_dq(sq, sk, sv, o, lse, sdo),
           *att.flash_attention_bwd_dkv(sq, sk, sv, o, lse, sdo))
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (2, 300, 300, 12, 2, 128, True, 0, False),
    (2, 300, 300, 8, 1, 64, True, 48, False),
    (1, 200, 129, 6, 6, 128, False, 0, False),
    (2, 300, 300, 12, 2, 128, True, 0, True)])
def test_flash_attention_bf16_forward_is_bit_reproducible(case):
    """The bf16 tensor-core forward sums in a fixed order, with no
    atomics: two runs give the same o and lse bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, lq, lk, h, kvh, d, causal, window, segments = case
    q, k, v, _, seg = _att_inputs(b, lq, lk, h, kvh, d, torch.bfloat16,
                                  segments, seed=6)
    kw = dict(causal=causal, window=window, segment_ids=seg)
    (o1, l1), (o2, l2) = (att.flash_attention_fwd(q, k, v, **kw)
                          for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [8, 4])
def test_flash_attention_bf16_forward_reads_strided_inputs(pad):
    """q, k and v as views into wider rows: with 8 elements of padding
    the forward reads them through their strides, with 4 the wrapper
    copies them first; either way o and lse equal those of contiguous
    inputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, l, h, kvh, d = 2, 200, 12, 2, 128
    q, k, v, _, _ = _att_inputs(b, l, l, h, kvh, d, torch.bfloat16, False,
                                seed=7)

    def strided(t):
        wide = torch.zeros(*t.shape[:3], d + pad, dtype=t.dtype,
                           device="cuda")
        wide[..., :d] = t
        return wide[..., :d]

    want = att.flash_attention_fwd(q, k, v)
    got = att.flash_attention_fwd(*(strided(t) for t in (q, k, v)))
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("l,window", [(300, 0), (200, 48)])
def test_flash_attention_bf16_forward_isolated_rows(l, window):
    """Every token its own segment: each query row sees only its own key,
    so in every k tile but the diagonal one its scores are all masked
    and its running max stays at the mask value. The forward must give
    finite outputs equal to v's row (p = 1, l = 1) within the limit, and
    the lse of a single visible score."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, h, kvh, d = 2, 12, 2, 128
    q, k, v, _, _ = _att_inputs(b, l, l, h, kvh, d, torch.bfloat16, False,
                                seed=8)
    seg = torch.arange(l, dtype=torch.int32, device="cuda") \
        .expand(b, l).contiguous()
    kw = dict(causal=True, window=window, segment_ids=seg)
    o, lse = att.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = att.flash_attention_reference(q, k, v, True, window,
                                                   seg, return_lse=True)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    lim = att.error_bound(q, k, v, o_ref, lse_ref, **kw)
    _within(o, o_ref, lim["o"], "o")
    _within(lse, lse_ref, 1e-5 * (1 + lse_ref.abs()), "lse")
    assert torch.equal(o, v.repeat_interleave(h // kvh, dim=2))


# ------------------------------------------------------------ fused AdamW

from tony_tpu_torch.ops import adamw as adw  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("copy", [None, torch.bfloat16])
def test_fused_adamw_kernel_matches_plain_version(gdt, mdt, copy):
    """The kernel and the plain version round every operation alike, so
    they agree to the bit (held to 1 ulp of fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = {"a": (1000, 300), "b": (7,), "c": (65536 + 5,)}
    opt = adw.FusedAdamW(learning_rate=3e-3, weight_decay=1e-2,
                         moment_dtype=mdt)
    params = {n: torch.randn(*s, device="cuda", generator=g)
              for n, s in shapes.items()}
    state = opt.init(params, compute_dtype=copy)
    ref_p = {n: t.clone() for n, t in params.items()}
    ref_s = opt.init(ref_p, compute_dtype=copy)
    for step in range(3):
        grads = {n: (0.1 * torch.randn(*s, device="cuda", generator=g))
                 .to(gdt) for n, s in shapes.items()}
        before = {n: t.clone() for n, t in grads.items()}
        n0 = adw.fused_adamw_update.launches
        params, state = adw.fused_adamw_update(opt, grads, state, params)
        assert adw.fused_adamw_update.launches == n0 + 1  # one group
        lr, c1, c2 = adw._hyper(opt, ref_s.count)
        for n in shapes:
            adw.leaf_update_reference(
                grads[n], ref_p[n], ref_s.mu[n], ref_s.nu[n], lr, c1, c2,
                b1=opt.b1, b2=opt.b2, eps=opt.eps, wd=opt.weight_decay,
                copy=None if copy is None else ref_s.compute_params[n])
        ref_s = ref_s._replace(count=ref_s.count + 1)
        torch.cuda.synchronize()
        assert all(torch.equal(grads[n], before[n]) for n in shapes)
        for n in shapes:
            for got, want in ((params[n], ref_p[n]),
                              (state.mu[n], ref_s.mu[n]),
                              (state.nu[n], ref_s.nu[n])):
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=2.0 ** -23, atol=0)
            if copy is not None:
                torch.testing.assert_close(
                    state.compute_params[n].float(),
                    ref_s.compute_params[n].float(), rtol=2.0 ** -8, atol=0)
    assert int(state.count) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("copy", [None, torch.bfloat16])
def test_fused_adamw_kernel_writes_only_its_leaves(copy):
    """Every param, moment and copy is a window into a larger buffer with
    a canary on both sides, at sizes around the kernel's chunk: the
    canaries survive, the grads are left as they were, and the results
    equal the plain version's (held to 1 ulp of fp32, as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    chunk = adw._kernel()[1]
    sizes = {"a": chunk - 1, "b": chunk, "c": chunk + 1, "d": 3 * chunk + 5,
             "e": 1}
    g = torch.Generator(device="cuda").manual_seed(5)
    pad = 4096
    bufs = []

    def guarded(values, dtype):
        buf = torch.full((pad + values.numel() + pad,), -7.25, dtype=dtype,
                         device="cuda")
        bufs.append(buf)
        view = buf[pad:pad + values.numel()]
        view.copy_(values)
        return view

    def leaves(scale, dtype=torch.float32):
        return {n: guarded(scale * torch.randn(s, device="cuda",
                                               generator=g).abs(), dtype)
                for n, s in sizes.items()}

    opt = adw.FusedAdamW(learning_rate=3e-3, weight_decay=1e-2)
    state = adw.FusedAdamWState(
        count=torch.ones((), dtype=torch.int32, device="cuda"),
        mu=leaves(1e-2), nu=leaves(1e-4),
        compute_params=None if copy is None else leaves(0.0, copy))
    params = leaves(1.0)
    grads = {n: (0.1 * torch.randn(s, device="cuda", generator=g))
             .bfloat16() for n, s in sizes.items()}
    grads_before = {n: t.clone() for n, t in grads.items()}

    def clones(d):
        return None if d is None else {n: t.clone() for n, t in d.items()}

    ref_p, ref_mu, ref_nu, ref_c = (clones(params), clones(state.mu),
                                    clones(state.nu),
                                    clones(state.compute_params))
    n0 = adw.fused_adamw_update.launches
    # the hyperparameters at the count the update reads (it advances the
    # count in place)
    lr, c1, c2 = adw._hyper(opt, state.count)
    adw.fused_adamw_update(opt, grads, state, params)
    for n in sizes:
        adw.leaf_update_reference(
            grads[n], ref_p[n], ref_mu[n], ref_nu[n], lr, c1, c2, b1=opt.b1,
            b2=opt.b2, eps=opt.eps, wd=opt.weight_decay,
            copy=None if ref_c is None else ref_c[n])
    torch.cuda.synchronize()
    assert adw.fused_adamw_update.launches == n0 + 1
    for buf in bufs:
        assert (buf[:pad] == -7.25).all() and (buf[-pad:] == -7.25).all()
    assert all(torch.equal(grads[n], grads_before[n]) for n in sizes)
    pairs = [(params, ref_p), (state.mu, ref_mu), (state.nu, ref_nu)]
    for got, want in pairs:
        for n in sizes:
            torch.testing.assert_close(got[n], want[n], rtol=2.0 ** -23,
                                       atol=0)
    if copy is not None:
        for n in sizes:
            torch.testing.assert_close(state.compute_params[n].float(),
                                       ref_c[n].float(), rtol=2.0 ** -8,
                                       atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("copy", [None, torch.bfloat16])
def test_fused_adamw_vector_and_scalar_paths_are_bit_equal(gdt, mdt, copy):
    """Leaves of 1, 3, 5 and 65,537 elements (no whole vector, a ragged
    tail, a tail past a chunk), a leaf whose every array starts at an odd
    element (a scalar head before the vectors) and one whose param alone
    does (arrays misaligned against each other: all scalar), over two
    steps: every param, moment and copy bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(11)
    sizes = {"one": 1, "three": 3, "five": 5, "chunk+1": 65537,
             "odd": 4099, "param-odd": 1029}

    def make(n, dtype, scale, odd):  # odd: a view from element 1
        t = scale * torch.randn(n + 1, device="cuda", generator=g)
        return t.to(dtype)[1:] if odd else t[:n].to(dtype).contiguous()

    def tree(dtype, scale, which):
        return {n: make(s, dtype, scale, n == "odd" or n == which)
                for n, s in sizes.items()}

    opt = adw.FusedAdamW(learning_rate=3e-3, weight_decay=1e-2,
                         moment_dtype=mdt)
    params = tree(torch.float32, 1.0, "param-odd")
    state = adw.FusedAdamWState(
        count=torch.zeros((), dtype=torch.int32, device="cuda"),
        mu=tree(mdt, 1e-2, None),
        nu={n: t.abs_() for n, t in tree(mdt, 1e-4, None).items()},
        compute_params=None if copy is None else tree(copy, 0.0, None))
    assert params["odd"].data_ptr() % 16 != 0
    assert adw.vector_head([(params["odd"].data_ptr(), 4),
                            (state.mu["odd"].data_ptr(), mdt.itemsize)]) > 0

    def clone(d):
        return None if d is None else {n: t.clone() for n, t in d.items()}

    ref_p, ref_mu, ref_nu, ref_c = (clone(params), clone(state.mu),
                                    clone(state.nu),
                                    clone(state.compute_params))
    for step in range(2):
        grads = tree(gdt, 0.1, None)
        lr, c1, c2 = adw._hyper(opt, state.count)
        n0 = adw.fused_adamw_update.launches
        params, state = adw.fused_adamw_update(opt, grads, state, params)
        assert adw.fused_adamw_update.launches == n0 + 1
        for n in sizes:
            adw.leaf_update_reference(
                grads[n], ref_p[n], ref_mu[n], ref_nu[n], lr, c1, c2,
                b1=opt.b1, b2=opt.b2, eps=opt.eps, wd=opt.weight_decay,
                copy=None if ref_c is None else ref_c[n])
        torch.cuda.synchronize()
        for n in sizes:
            assert torch.equal(params[n], ref_p[n]), (step, n)
            assert torch.equal(state.mu[n], ref_mu[n]), (step, n)
            assert torch.equal(state.nu[n], ref_nu[n]), (step, n)
            if copy is not None:
                assert torch.equal(state.compute_params[n], ref_c[n]), n


@pytest.mark.cuda
def test_fused_adamw_cached_table_rechecks_shapes():
    """After a step has cached the group's table, a grad shortened by a
    view at the same address is refused, as it is on a first call, and
    launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    opt = adw.FusedAdamW(learning_rate=3e-3)
    params = {"w": torch.randn(4099, device="cuda")}
    state = opt.init(params)
    grads = {"w": torch.randn(4099, device="cuda")}
    params, state = adw.fused_adamw_update(opt, grads, state, params)
    n0 = adw.fused_adamw_update.launches
    with pytest.raises(ValueError):
        adw.fused_adamw_update(opt, {"w": grads["w"][:4095]}, state, params)
    assert adw.fused_adamw_update.launches == n0


# ------------------------------------------------------ int8 q8_matmul
# Per element |got - want| <= ops.quant.error_bound: 2^-7 |want| for a
# bf16 output (the two roundings may land one bf16 step apart) plus
# 2^-14 M, M = scale_j sum_k |x_ik| |q_kj| (fp32 sums in another order).

from tony_tpu_torch.ops import quant as q8  # noqa: E402

Q8_SHAPES = [  # m, k, n: every route and x-row count, ragged edges,
    # splits, a k that is not a multiple of a stage (64 or 32 rows)
    (1, 1536, 256), (8, 1536, 8960), (16, 8960, 1536), (17, 1000, 300),
    (257, 1000, 300), (300, 96, 40), (5, 7, 3), (128, 1536, 1536),
    (2, 1536, 8960), (9, 1536, 8960), (15, 1536, 8960), (16, 1536, 8960),
    (17, 1536, 8960), (8, 1000, 1536), (200, 1000, 1536)]


def _q8_inputs(m, k, n, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
    w_q, scale = q8.quantize_q8(
        0.02 * torch.randn(k, n, device="cuda", generator=g))
    return x, w_q, scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", Q8_SHAPES)
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.float32)])
def test_q8_matmul_kernel_matches_plain_version(shape, dtype, out_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, w_q, scale = _q8_inputs(*shape, dtype)
    before = [t.clone() for t in (x, w_q, scale)]
    n0 = q8.q8_matmul.launches
    got = q8.q8_matmul(x, w_q, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert q8.q8_matmul.launches == n0 + 1
    assert all(torch.equal(a, b) for a, b in zip((x, w_q, scale), before))
    want = q8.q8_matmul_reference(x, w_q, scale, out_dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    _within(got, want, q8.error_bound(x, w_q, scale, want), "q8_matmul")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_matmul_limit_catches_a_dropped_slice_or_scale(dtype):
    """The kernel's own result sits inside the limit; a plain result
    with one 32-wide k-slice dropped, or one column left unscaled,
    does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, w_q, scale = _q8_inputs(8, 1536, 8960, dtype, seed=2)
    got = q8.q8_matmul(x, w_q, scale)
    want = q8.q8_matmul_reference(x, w_q, scale)
    limit = q8.error_bound(x, w_q, scale, want)
    _within(got, want, limit, "q8_matmul")
    dropped = x.clone()
    dropped[:, 640:672] = 0
    unscaled = scale.clone()
    unscaled[4321] = 1.0
    for wrong in (q8.q8_matmul_reference(dropped, w_q, scale),
                  q8.q8_matmul_reference(x, w_q, unscaled)):
        assert ((got.float() - wrong.float()).abs() - limit).max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1536, 8960), (17, 1000, 300),
                                   (257, 96, 40), (257, 1000, 40),
                                   (1, 1536, 256)])
def test_q8_matmul_kernel_writes_only_its_outputs(shape):
    """The C entry point gets the output and the split-K scratch as
    windows into larger buffers with a canary on both sides: the
    canaries survive and the result equals the wrapper's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    m, k, n = shape
    x, w_q, scale = _q8_inputs(m, k, n, torch.bfloat16, seed=1)
    want = q8.q8_matmul(x, w_q, scale)
    p = q8.plan(m, n, k, x.dtype, q8._sms(x.device.index))
    pad = 4096

    def guarded(count, dtype):
        buf = torch.full((pad + count + pad,), -7.25, dtype=dtype,
                         device="cuda")
        return buf, buf[pad:pad + count]

    out_buf, out = guarded(m * n, torch.bfloat16)
    part_buf, part = guarded(p.splits * m * n, torch.float32)
    err = q8._lib().tony_q8_matmul(
        1, 1, x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), part.data_ptr(), m, n, k, p.route, p.splits, p.kps,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for buf in (out_buf, part_buf):
        assert (buf[:pad] == -7.25).all() and (buf[-pad:] == -7.25).all()
    assert torch.equal(out.view(m, n), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1536, 8960), (1, 1536, 256),
                                   (16, 8960, 1536), (4096, 1536, 8960),
                                   (17, 1000, 300), (300, 1000, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_matmul_rerun_gives_the_same_bits(shape, dtype):
    """Split-K sums add in split order and the warps' sums in warp order
    (no float atomics): a second and third call give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, w_q, scale = _q8_inputs(*shape, dtype, seed=3)
    first = q8.q8_matmul(x, w_q, scale)
    for _ in range(2):
        assert torch.equal(q8.q8_matmul(x, w_q, scale), first)


@pytest.mark.cuda
@pytest.mark.parametrize("m,dtype,route", [
    (8, torch.bfloat16, 0), (4096, torch.bfloat16, 1),
    (8, torch.float32, 0), (4096, torch.float32, 2), (16, torch.bfloat16, 0),
    (17, torch.bfloat16, 1)])
def test_q8_matmul_route_by_rows_and_dtype(m, dtype, route):
    """The CUDA source's route (tony_q8_matmul_route) is the plan's: the
    decode route at m = 8, the tensor cores at m = 4096 for a bf16 x."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    assert q8.kernel_route(dtype, m) == route
    assert q8.plan(m, 8960, 1536, dtype, 132).route == route
    x, w_q, scale = _q8_inputs(m, 1536, 8960, dtype, seed=4)
    got = q8.q8_matmul(x, w_q, scale)
    want = q8.q8_matmul_reference(x, w_q, scale)
    _within(got, want, q8.error_bound(x, w_q, scale, want), "q8_matmul")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 1536, 8960), (1, 1000, 300),
                                   (300, 1536, 1536), (33, 999, 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_matmul_reads_x_at_an_odd_offset(m, k, n, dtype):
    """x a contiguous view whose base sits one element into its buffer
    (not 16-byte aligned), and the weights one byte into theirs: the
    kernel takes its element-wise loads, agrees with the plain version
    and gives the bits of an aligned call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x0, w0, scale = _q8_inputs(m, k, n, dtype, seed=5)
    xb = torch.empty(m * k + 1, dtype=dtype, device="cuda")
    xb[1:].copy_(x0.reshape(-1))
    x = xb[1:].view(m, k)
    wb = torch.empty(k * n + 1, dtype=torch.int8, device="cuda")
    wb[1:].copy_(w0.reshape(-1))
    w_q = wb[1:].view(k, n)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = q8.q8_matmul(x, w_q, scale)
    want = q8.q8_matmul_reference(x, w_q, scale)
    _within(got, want, q8.error_bound(x, w_q, scale, want), "q8_matmul")
    # the same values land in shared memory either way: the same bits
    assert torch.equal(got, q8.q8_matmul(x0, w0, scale))


@pytest.mark.cuda
def test_q8_matmul_kernel_refuses_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, w_q, scale = _q8_inputs(4, 64, 32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        q8.q8_matmul(x.t().contiguous().t(), w_q, scale)
    with pytest.raises(ValueError, match="float32"):
        q8.q8_matmul(x, w_q, scale.bfloat16())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        q8.q8_matmul(x.half(), w_q, scale)


# ------------------------------------------------------------ fused norms
# Per element: 2^-7 |want| for a bf16 output (one bf16 step), 2^-20 |want|
# + 1e-7 for fp32 (the mean of squares summed in another order, an rsqrt
# within 2 ulp); summed bit-equal.

from tony_tpu_torch.ops import fused  # noqa: E402


def _norm_limit(want):
    if want.dtype == torch.bfloat16:
        return 2.0 ** -7 * want.float().abs()
    return 2.0 ** -20 * want.abs() + 1e-7


# widths on each side of every route boundary of ``fused.plan``: one warp
# a row up to 1024 (both dtypes), two to 2048, ..., eight to 8192 (the
# widest one-pass row), the two-pass route above it
NORM_WIDTHS = [(8, 1536), (37, 1000), (5, 100), (1, 7), (3, 1024),
               (2, 1025), (4, 2048), (3, 2049), (1, 4096), (2, 4097),
               (6, 8192), (3, 8193), (2, 12289), (1, 1536)]


def _norm_inputs(rows, d, x_dt, r_dt, s_dt, seed, offset=0):
    """x, r and scale; with ``offset``, x and r are views one element
    past a 16-byte boundary, so every row takes the scalar head and
    tail (or runs element by element beside its aligned outputs)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bufs = [torch.randn(offset + rows * d, device="cuda", generator=g)
            .to(dt) for dt in (x_dt, r_dt)]
    x, r = (b[offset:].view(rows, d) for b in bufs)
    scale = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(s_dt)
    return x, r, scale


NORM_DTYPES = [(torch.float32, torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.float32, torch.bfloat16),
               (torch.float32, torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", NORM_WIDTHS)
@pytest.mark.parametrize("x_dt,r_dt,s_dt", NORM_DTYPES)
def test_norm_kernels_match_plain_version(rows, d, x_dt, r_dt, s_dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, r, scale = _norm_inputs(rows, d, x_dt, r_dt, s_dt, rows + d)
    before = [t.clone() for t in (x, r, scale)]
    n0 = (fused.rmsnorm.launches, fused.add_rmsnorm.launches)
    out = fused.rmsnorm(x, scale)
    normed, summed = fused.add_rmsnorm(x, r, scale)
    torch.cuda.synchronize()
    assert (fused.rmsnorm.launches, fused.add_rmsnorm.launches) == \
        (n0[0] + 1, n0[1] + 1)
    assert all(torch.equal(a, b) for a, b in zip((x, r, scale), before))
    want = fused.rmsnorm_reference(x, scale)
    want_n, want_s = fused.add_rmsnorm_reference(x, r, scale)
    assert out.dtype == normed.dtype == summed.dtype == x_dt
    assert torch.equal(summed, want_s)
    _within(out, want, _norm_limit(want), "rmsnorm")
    _within(normed, want_n, _norm_limit(want_n), "add_rmsnorm")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(9, 1536), (5, 1001), (3, 4096),
                                    (2, 8192), (2, 12289)])
@pytest.mark.parametrize("x_dt,r_dt,s_dt", NORM_DTYPES)
def test_norm_kernels_take_misaligned_rows(rows, d, x_dt, r_dt, s_dt):
    """Inputs one element off a 16-byte boundary (and, at D = 1001,
    rows that start at every offset): the scalar head and tail, or the
    element-by-element rows, meet the same limits, ``summed`` bit-equal,
    and a rerun gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, r, scale = _norm_inputs(rows, d, x_dt, r_dt, s_dt, d, offset=1)
    assert x.data_ptr() % 16 != 0
    out = fused.rmsnorm(x, scale)
    normed, summed = fused.add_rmsnorm(x, r, scale)
    want = fused.rmsnorm_reference(x, scale)
    want_n, want_s = fused.add_rmsnorm_reference(x, r, scale)
    assert torch.equal(summed, want_s)
    _within(out, want, _norm_limit(want), "rmsnorm")
    _within(normed, want_n, _norm_limit(want_n), "add_rmsnorm")
    assert torch.equal(fused.rmsnorm(x, scale), out)
    again_n, again_s = fused.add_rmsnorm(x, r, scale)
    assert torch.equal(again_n, normed) and torch.equal(again_s, summed)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype", [(8192, 1536, torch.bfloat16),
                                          (8192, 1536, torch.float32),
                                          (300, 8192, torch.float32),
                                          (64, 12289, torch.bfloat16)])
def test_norm_kernels_rerun_bit_equal(rows, d, dtype):
    """Many rows a block in turn (the grid is one wave, so the blocks
    loop): a second call gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, r, scale = _norm_inputs(rows, d, dtype, dtype, torch.float32, rows)
    out = fused.rmsnorm(x, scale)
    normed, summed = fused.add_rmsnorm(x, r, scale)
    assert torch.equal(fused.rmsnorm(x, scale), out)
    again_n, again_s = fused.add_rmsnorm(x, r, scale)
    assert torch.equal(again_n, normed) and torch.equal(again_s, summed)
    want = fused.rmsnorm_reference(x, scale)
    _within(out, want, _norm_limit(want), "rmsnorm")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1536, 100, 4096])
def test_norm_kernels_write_only_their_outputs(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rows, pad = 13, 4096
    g = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn(rows, d, device="cuda", generator=g).bfloat16()
    r = torch.randn(rows, d, device="cuda", generator=g)
    scale = torch.randn(d, device="cuda", generator=g)
    want = fused.rmsnorm(x, scale)
    want_n, want_s = fused.add_rmsnorm(x, r, scale)
    bufs = [torch.full((pad + rows * d + pad,), -7.25, dtype=x.dtype,
                       device="cuda") for _ in range(3)]
    views = [b[pad:pad + rows * d] for b in bufs]
    lib = fused._kernels()
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = fused.plan(rows, d, x.dtype, None, sms)
    assert lib.tony_rmsnorm(1, 0, x.data_ptr(), scale.data_ptr(),
                            views[0].data_ptr(), rows, d, 1e-6, *p,
                            stream) == 0
    p = fused.plan(rows, d, x.dtype, r.dtype, sms)
    assert lib.tony_add_rmsnorm(1, 0, 0, x.data_ptr(), r.data_ptr(),
                                scale.data_ptr(), views[1].data_ptr(),
                                views[2].data_ptr(), rows, d, 1e-6, *p,
                                stream) == 0
    torch.cuda.synchronize()
    for buf in bufs:
        assert (buf[:pad] == -7.25).all() and (buf[-pad:] == -7.25).all()
    for view, w in zip(views, (want, want_n, want_s)):
        assert torch.equal(view.view(rows, d), w)


@pytest.mark.cuda
def test_norm_kernels_refuse_a_plan_they_do_not_take():
    """The entry points check the plan they are given against their own
    rule and return -1 without launching; the library's constants are
    the plan's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x = torch.randn(16, 1536, device="cuda")
    scale = torch.ones(1536, device="cuda")
    out = torch.empty_like(x)
    lib = fused._kernels()
    stream = torch.cuda.current_stream().cuda_stream
    p = fused.plan(16, 1536, x.dtype, None, 132)
    blocks = -(-16 // p.block_rows)
    for bad in (p._replace(lane_vectors=p.lane_vectors - 1),
                p._replace(row_warps=p.row_warps + 1),
                p._replace(block_rows=2 * p.block_rows),
                p._replace(route=fused.TWO_PASS), p._replace(grid=0),
                p._replace(grid=blocks + 1)):
        assert lib.tony_rmsnorm(0, 0, x.data_ptr(), scale.data_ptr(),
                                out.data_ptr(), 16, 1536, 1e-6, *bad,
                                stream) == -1


# ------------------------------------- expert-batched q8_matmul (MoE)
# q8_matmul_experts: jax.vmap(q8_matmul) over the expert axis in one
# launch. Per element within ops.quant.error_bound, as above.

Q8E_SHAPES = [  # experts, m, k, n: every route, ragged edges, splits
    (8, 8, 512, 1792), (4, 1, 1536, 256), (3, 16, 1000, 300),
    (3, 17, 1000, 300), (2, 257, 1000, 300), (4, 5, 7, 3),
    (8, 64, 512, 1024), (2, 300, 96, 40)]


def _q8e_inputs(e, m, k, n, dtype, broadcast, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (m, k) if broadcast else (e, m, k)
    x = torch.randn(*shape, device="cuda", generator=g).to(dtype)
    w = 0.02 * torch.randn(e, k, n, device="cuda", generator=g)
    scale = torch.clamp(w.abs().amax(dim=1), min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale[:, None, :]), -127,
                      127).to(torch.int8)
    return x, w_q, scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", Q8E_SHAPES)
@pytest.mark.parametrize("broadcast", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_matmul_experts_kernel_matches_plain_version(shape, broadcast,
                                                        dtype):
    """One launch for every expert, broadcast x (stride 0) and batched x,
    every route; inputs untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, w_q, scale = _q8e_inputs(*shape, dtype, broadcast)
    before = [t.clone() for t in (x, w_q, scale)]
    n0 = q8.q8_matmul_experts.launches
    got = q8.q8_matmul_experts(x, w_q, scale)
    torch.cuda.synchronize()
    assert q8.q8_matmul_experts.launches == n0 + 1
    assert all(torch.equal(a, b) for a, b in zip((x, w_q, scale), before))
    want = q8.q8_matmul_experts_reference(x, w_q, scale)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    _within(got, want, q8.error_bound(x, w_q, scale, want),
            "q8_matmul_experts")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8, 512, 1792), (3, 17, 1000, 300),
                                   (2, 257, 96, 40), (4, 1, 1536, 256)])
@pytest.mark.parametrize("broadcast", [True, False])
def test_q8_matmul_experts_writes_only_its_outputs(shape, broadcast):
    """Output and split-K scratch as windows into guarded buffers: the
    canaries survive and the result is the wrapper's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    e, m, k, n = shape
    x, w_q, scale = _q8e_inputs(e, m, k, n, torch.bfloat16, broadcast,
                                seed=1)
    want = q8.q8_matmul_experts(x, w_q, scale)
    p = q8.plan(m, n, k, x.dtype, q8._sms(x.device.index), e)
    pad = 4096

    def guarded(count, dtype):
        buf = torch.full((pad + count + pad,), -7.25, dtype=dtype,
                         device="cuda")
        return buf, buf[pad:pad + count]

    out_buf, out = guarded(e * m * n, torch.bfloat16)
    part_buf, part = guarded(e * p.splits * m * n, torch.float32)
    err = q8._lib().tony_q8_matmul_experts(
        1, 1, x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), part.data_ptr(), e, 0 if broadcast else m * k, m,
        n, k, p.route, p.splits, p.kps,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for buf in (out_buf, part_buf):
        assert (buf[:pad] == -7.25).all() and (buf[-pad:] == -7.25).all()
    assert torch.equal(out.view(e, m, n), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8, 512, 1792), (3, 17, 1000, 300),
                                   (2, 300, 1000, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_matmul_experts_rerun_gives_the_same_bits(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, w_q, scale = _q8e_inputs(*shape, dtype, False, seed=3)
    first = q8.q8_matmul_experts(x, w_q, scale)
    for _ in range(2):
        assert torch.equal(q8.q8_matmul_experts(x, w_q, scale), first)


@pytest.mark.cuda
def test_q8_matmul_experts_each_expert_reads_its_own_matrix():
    """Experts with different weights and x rows: expert e's output is
    the plain product of its own x and weight (a kernel reading expert
    0's matrices everywhere fails)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, w_q, scale = _q8e_inputs(4, 8, 512, 640, torch.bfloat16, False,
                                seed=5)
    got = q8.q8_matmul_experts(x, w_q, scale)
    for e in range(4):
        want = q8.q8_matmul_reference(x[e], w_q[e], scale[e])
        _within(got[e], want, q8.error_bound(x[e], w_q[e], scale[e], want),
                f"expert {e}")
        other = q8.q8_matmul_reference(x[e], w_q[(e + 1) % 4],
                                       scale[(e + 1) % 4])
        assert not torch.equal(got[e], other)
