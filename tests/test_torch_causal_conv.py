"""Mamba2's causal conv (``kernels/causal_conv.py``) on the CPU: the plain
pair that ``CausalConv`` runs on CPU tensors, and the kernels' wrappers'
refusals. The kernels themselves are held to the plain pair on a card
(``tests/test_torch_cuda.py``).

Every case runs in bf16 and fp32, with and without a halo, on the strided
``xBC`` view of an input projection as ``models/mamba2.py`` splits it.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import causal_conv as cc
from repro_torch.kernels.causal_conv import CausalConv, ref_causal_conv, ref_causal_conv_bwd

DTYPES = [torch.bfloat16, torch.float32]
# (b, s, c): the conv at a batch of 3, s < K, s = K, a ragged c, a longer run
SHAPES = [(3, 9, 16), (2, 2, 8), (1, 4, 24), (2, 11, 37), (1, 70, 20)]
Z, DT = 5, 3                    # the projection's z and dt columns around xBC


def _parent_conv1d(u, w, bias, halo=None):
    """``models/mamba2.py::_conv1d`` as it was before the kernels: the
    arithmetic the CPU path must keep bit for bit."""
    K, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0)) if halo is None else torch.cat([halo, u], dim=1)
    out = torch.zeros_like(u)
    for i in range(K):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + bias)


def _inputs(b, s, c, dtype, halo, seed=0):
    """xBC as a strided view of a [b, s, Z + c + DT] projection, taps,
    bias, an optional halo and the output's gradient."""
    g = torch.Generator().manual_seed(seed)
    zxbcdt = torch.randn(b, s, Z + c + DT, generator=g).to(dtype)
    u = zxbcdt.split([Z, c, DT], dim=-1)[1]
    w = (torch.rand(4, c, generator=g) - 0.5).to(dtype)
    bias = (torch.rand(c, generator=g) - 0.5).to(dtype)
    h = torch.randn(b, 3, c, generator=g).to(dtype) if halo else None
    gy = torch.randn(b, s, c, generator=g).to(dtype)
    return zxbcdt, u, w, bias, h, gy


def _opt(t, f):
    return None if t is None else f(t)


@pytest.mark.parametrize("b,s,c", SHAPES)
@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_path_is_the_models_arithmetic_bit_for_bit(b, s, c, halo, dtype):
    _, u, w, bias, h, _ = _inputs(b, s, c, dtype, halo)
    assert not u.is_contiguous()
    want = _parent_conv1d(u, w, bias, h)
    assert torch.equal(CausalConv.apply(u, w, bias, h), want)
    leaves = [t.detach().requires_grad_() for t in (u, w, bias)]
    got = CausalConv.apply(*leaves, h)
    assert got.requires_grad and torch.equal(got.detach(), want)


@pytest.mark.parametrize("b,s,c", SHAPES)
@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_backward_is_autograd_of_the_plain_forward(b, s, c, halo, dtype):
    """In fp64 the explicit backward equals autograd's; on the inputs'
    own dtype it computes in fp32 and rounds each gradient once, within
    one rounding of that dtype of the fp64 gradient's largest |value|."""
    _, u, w, bias, h, gy = _inputs(b, s, c, dtype, halo, seed=1)
    d = [_opt(t, lambda t: t.double().requires_grad_()) for t in (u, w, bias, h)]
    torch.autograd.backward(ref_causal_conv(*d), gy.double())
    want = [_opt(t, lambda t: t.grad) for t in d]
    exact = ref_causal_conv_bwd(*(_opt(t, lambda t: t.detach()) for t in d), gy.double())
    got = ref_causal_conv_bwd(u, w, bias, h, gy)
    tol = 2 ** -8 if dtype == torch.bfloat16 else 1e-5      # fp32: sums of up to b s terms
    for name, e, g, wnt, x in zip(("gu", "gw", "gb", "ghalo"), exact, got, want, (u, w, bias, h)):
        if x is None:
            assert e is None and g is None and wnt is None
            continue
        scale = wnt.abs().max().item()
        assert (e - wnt).abs().max().item() <= 1e-12 * scale, name
        assert g.dtype == dtype and g.shape == x.shape, name
        assert (g.double() - wnt).abs().max().item() <= tol * scale, name


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_through_the_view_lands_in_xbc_columns(halo, dtype):
    """``CausalConv``'s backward on CPU tensors is ``ref_causal_conv_bwd``,
    and u's gradient reaches the projection's xBC columns alone."""
    zxbcdt, _, w, bias, h, gy = _inputs(2, 11, 37, dtype, halo, seed=2)
    zx = zxbcdt.detach().requires_grad_()
    leaves = [t.detach().requires_grad_() for t in (w, bias)]
    hl = _opt(h, lambda t: t.detach().requires_grad_())
    u = zx.split([Z, 37, DT], dim=-1)[1]
    torch.autograd.backward(CausalConv.apply(u, *leaves, hl), gy)
    gu, gw, gb, gh = ref_causal_conv_bwd(u.detach(), w, bias, h, gy)
    assert torch.equal(zx.grad[..., Z:Z + 37], gu)
    assert not zx.grad[..., :Z].any() and not zx.grad[..., Z + 37:].any()
    assert torch.equal(leaves[0].grad, gw) and torch.equal(leaves[1].grad, gb)
    assert (hl is None and gh is None) or torch.equal(hl.grad, gh)


def _defect(name, dtype):
    """The wrappers' arguments with one defect each."""
    _, u, w, bias, h, gy = _inputs(2, 9, 16, dtype, True)
    args = {"u": u, "w": w, "bias": bias, "halo": h, "gy": gy}
    other = torch.float16
    if name == "dtype_u":
        args = {k: t.to(other) for k, t in args.items()}
    elif name == "dtype_w":
        args["w"] = w.to(other)
    elif name == "dtype_halo":
        args["halo"] = h.to(other)
    elif name == "channel_stride":
        args["u"] = torch.randn(2, 16, 9).to(dtype).transpose(1, 2)
    elif name == "channel_stride_gy":
        args["gy"] = torch.randn(2, 16, 9).to(dtype).transpose(1, 2)
    elif name == "taps_3":
        args["w"] = w[:3].contiguous()
    elif name == "taps_5":
        args["w"] = torch.cat([w, w[:1]]).contiguous()
    elif name == "halo_shape":
        args["halo"] = h[:, 1:].contiguous()
    elif name == "halo_batch":
        args["halo"] = h[:1].contiguous()
    return args


# the message each defect raises with; gy's only the backward takes
DEFECTS = {"dtype_u": "dtype", "dtype_w": "dtype", "dtype_halo": "dtype",
           "channel_stride": "channel stride", "channel_stride_gy": "channel stride",
           "taps_3": "K = 4", "taps_5": "K = 4", "halo_shape": "halo: shape",
           "halo_batch": "halo: shape", "device": "CUDA tensor"}
BACKWARD_ONLY = {"channel_stride_gy"}


@pytest.mark.parametrize("defect", sorted(DEFECTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_refuse_what_the_kernels_do_not_take(defect, dtype):
    """Each defect raises in both wrappers before anything is launched
    (the device is checked last, so a CPU tensor shows the others)."""
    a = _defect(defect, dtype)
    if defect not in BACKWARD_ONLY:
        with pytest.raises(ValueError, match=DEFECTS[defect]):
            cc.causal_conv(a["u"], a["w"], a["bias"], a["halo"])
    with pytest.raises(ValueError, match=DEFECTS[defect]):
        cc.causal_conv_bwd(a["u"], a["w"], a["bias"], a["halo"], a["gy"])


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_wrappers_count_as_their_plain_versions(which, halo):
    """Inside ``tally()`` a wrapper adds the result bytes (and the products:
    none) that its plain version counts on the same arguments, and none of
    its own ops, so a step's tally is the same on the card and the CPU."""
    from repro_torch.launch.tally import tally
    from repro_torch.tally_hooks import counts_as

    _, u, w, bias, h, gy = _inputs(2, 11, 37, torch.bfloat16, halo)
    plain, args = ((ref_causal_conv, (u, w, bias, h)) if which == "forward"
                   else (ref_causal_conv_bwd, (u, w, bias, h, gy)))

    def kernel(*a):                  # a stand-in whose own ops must not count
        return torch.empty(1000) + 1
    with tally() as want:
        plain(*args)
    with tally() as got:
        counts_as(plain)(kernel)(*args)
    assert want.result_bytes > 0 and want.dot_flops == 0
    assert (got.dot_flops, got.result_bytes) == (want.dot_flops, want.result_bytes)
