"""WaveGlow's WN passes (``msa_tts_tpu_torch/csrc/waveglow_wn.cu``,
wrapper ``vocoders/cuda_wn.py``) against the eager ops they replace, on
the GPU, bit for bit: the gate and the residual pass in bfloat16 and
float32 at C = 4, 6 and 256 over position counts that are no multiple of
a vector, with rows of unequal length under the pad mask; the gate op by
op; the wrapper's refusals; and one served ``infer_batch`` at the
published width against the eager path.

A difference is reported by the op or output it is in and the count of
elements that differ; nothing is compared within a tolerance.

These tests need a CUDA device and nvcc; elsewhere they skip.  On the GPU
host (no jax there, so without the JAX-side conftest):

    python -m pytest tests/test_torch_waveglow_cuda.py --noconftest -o addopts="" -m cuda -q
"""

import pytest
import torch

from msa_tts_tpu_torch.vocoders import cuda_wn as CW
from msa_tts_tpu_torch.vocoders import waveglow as WG
from tools.bench_waveglow import published_waveglow

pytestmark = pytest.mark.cuda

DTYPES = [torch.bfloat16, torch.float32]
WIDTHS = [4, 6, 256]
# (B, L): 111 and 7 positions, neither a multiple of a vector's 8
SHAPES = [(3, 37), (1, 7)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, seed, dtype, device, scale=2.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(device, dtype)


def _differ(got: torch.Tensor, want: torch.Tensor, what: str) -> str:
    """'' where the bits are equal, else which output and how many of its
    elements differ."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    n = int((got != want).sum()) if not torch.equal(got, want) else 0
    return f"{what}: {n} of {got.numel()} elements differ" if n else ""


def _pad(B, L, device):
    """Rows of unequal length: row b has L - 3 b real positions."""
    lengths = torch.tensor([max(L - 3 * b, 1) for b in range(B)],
                           device=device)
    return torch.arange(L, device=device)[None, :, None] >= lengths[:, None,
                                                                    None]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_gate_pass_equals_eager(device, dtype, C, shape):
    B, L = shape
    zc = _randn((B, L, 2 * C), 1, dtype, device)
    zd = _randn((B, L, 2 * C), 2, dtype, device)
    # values where tanh and sigmoid saturate, and zeros
    zc[0, 0, :] = torch.linspace(-30, 30, 2 * C, device=device).to(dtype)
    zd[0, 0, :] = 0
    before = CW.WN_LAUNCHES
    got = CW.cuda_gate(zc, zd)
    assert CW.WN_LAUNCHES == before + 1
    assert not _differ(got, CW.gate_reference(zc, zd), "acts")


# Each case makes every other op of the gate exact, so a difference is
# this op's: zd = 0 makes the add exact; z₂ = 30 makes R(sigmoid z₂) = 1
# and z₁ = 30 makes R(tanh z₁) = 1, and a product with 1 is exact.
@pytest.mark.parametrize("op", ["add", "tanh", "sigmoid", "product"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_gate_pass_op_by_op(device, dtype, op):
    B, L, C = 4, 1001, 256
    zc = _randn((B, L, 2 * C), 3, dtype, device, scale=3.0)
    zd = _randn((B, L, 2 * C), 4, dtype, device, scale=3.0)
    if op == "add":
        zd[..., C:] = 0
    else:
        zd.zero_()
    if op in ("add", "tanh"):
        zc[..., C:] = 30.0
    if op == "sigmoid":
        zc[..., :C] = 30.0
    want = {
        "add": lambda z: torch.tanh(z[..., :C]),
        "tanh": lambda z: torch.tanh(z[..., :C]),
        "sigmoid": lambda z: torch.sigmoid(z[..., C:]),
        "product": lambda z: torch.tanh(z[..., :C]) * torch.sigmoid(z[..., C:]),
    }[op](zc + zd)
    if op != "product":
        assert torch.equal(CW.gate_reference(zc, zd), want)
    assert not _differ(CW.cuda_gate(zc, zd), want, op)


@pytest.mark.parametrize("layer", ["first", "middle", "last", "only"])
@pytest.mark.parametrize("masked", [False, True], ids=["equal", "padded"])
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_residual_pass_equals_eager(device, dtype, C, masked, layer):
    """``first``: skip is rs_skip; ``last``: rs is (B, L, C) and skip
    comes back float32; ``only``: a WN of one layer, both."""
    B, L = SHAPES[0]
    last = layer in ("last", "only")
    rs = _randn((B, L, C if last else 2 * C), 5, dtype, device)
    x = _randn((B, L, C), 6, dtype, device)
    skip = (None if layer in ("first", "only")
            else _randn((B, L, C), 7, dtype, device))
    pad = _pad(B, L, device) if masked else None
    want_x, want_skip = CW.residual_reference(
        rs, x.clone(), None if skip is None else skip.clone(), pad)
    x_in = x.clone()
    before = CW.WN_LAUNCHES
    got_x, got_skip = CW.cuda_residual(rs, x, skip, pad)
    assert CW.WN_LAUNCHES == before + 1
    assert got_x is x        # in place, or untouched at the last layer
    if last:
        assert got_skip.dtype == torch.float32
        assert torch.equal(x, x_in)
    elif skip is not None:
        assert got_skip is skip
    msg = [_differ(got_x, want_x, "x"), _differ(got_skip, want_skip, "skip")]
    assert not any(msg), "; ".join(m for m in msg if m)
    if masked and not last:
        assert not got_x.masked_select(pad).any()


def test_wrapper_refuses(device):
    C = 8
    zc = _randn((2, 5, 2 * C), 8, torch.bfloat16, device)
    zd = _randn((2, 5, 2 * C), 9, torch.bfloat16, device)
    with pytest.raises(ValueError, match="CUDA"):
        CW.cuda_gate(zc.cpu(), zd.cpu())
    with pytest.raises(ValueError, match="zd is on cpu"):
        CW.cuda_gate(zc, zd.cpu())
    with pytest.raises(TypeError, match="dtype"):
        CW.cuda_gate(zc.half(), zd.half())
    with pytest.raises(TypeError, match="zd has dtype"):
        CW.cuda_gate(zc, zd.float())
    with pytest.raises(ValueError, match="not contiguous"):
        CW.cuda_gate(zc, zd.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="shape"):
        CW.cuda_gate(zc, zd[:, :4])
    with pytest.raises(ValueError, match="2C"):
        CW.cuda_gate(zc[..., :-1].contiguous(), zd[..., :-1].contiguous())
    with pytest.raises(ValueError, match="address"):
        # a contiguous view 2 bytes off the allocation's alignment
        flat = _randn((2 * 5 * 2 * C + 1,), 10, torch.bfloat16, device)
        CW.cuda_gate(flat[1:].view(2, 5, 2 * C), zd)
    rs = _randn((2, 5, 2 * C), 11, torch.bfloat16, device)
    x = _randn((2, 5, C), 12, torch.bfloat16, device)
    with pytest.raises(ValueError, match="CUDA"):
        CW.cuda_residual(rs.cpu(), x.cpu(), None)
    with pytest.raises(ValueError, match="rs has shape"):
        CW.cuda_residual(rs[..., :-2].contiguous(), x, None)
    with pytest.raises(ValueError, match="skip has shape"):
        CW.cuda_residual(rs, x, x[:1].clone())
    with pytest.raises(TypeError, match="rs has dtype"):
        CW.cuda_residual(rs.float(), x, None)
    with pytest.raises(ValueError, match="not contiguous"):
        CW.cuda_residual(rs, x.transpose(0, 1).contiguous().transpose(0, 1),
                         None)
    with pytest.raises(TypeError, match="pad has dtype"):
        CW.cuda_residual(rs, x, None, _pad(2, 5, device).float())
    with pytest.raises(ValueError, match="pad has shape"):
        CW.cuda_residual(rs, x, None, _pad(2, 5, device)[..., 0])
    with pytest.raises(ValueError, match="distinct"):
        CW.cuda_residual(rs, x, x)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_served_infer_batch_equals_eager_path(device, dtype, monkeypatch):
    """Two rows of unequal length (the pad mask) at the published width:
    the served waveforms equal the eager path's bit for bit, through
    2 x 8 layers x 12 flows launches.  cuDNN is held to deterministic
    algorithms: in float32 it may take one for the upsampler's transposed
    convolution whose sums land in another order at each call."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    voc = WG.WaveGlowVocoder(published_waveglow(0), dtype=dtype,
                             device=device)
    g = torch.Generator().manual_seed(1)
    frames = [24, 17]
    mels = [torch.randn((80, t), generator=g) for t in frames]
    noise = [torch.randn((8, t * 32), generator=g) for t in frames]
    before = CW.WN_LAUNCHES
    served = voc.infer_batch(mels, noise)
    assert CW.WN_LAUNCHES - before == 2 * 8 * 12
    monkeypatch.setattr(CW, "cuda_gate", CW.gate_reference)
    monkeypatch.setattr(CW, "cuda_residual", CW.residual_reference)
    eager = voc.infer_batch(mels, noise)
    assert CW.WN_LAUNCHES - before == 2 * 8 * 12
    for i, (a, b) in enumerate(zip(served, eager)):
        assert a.shape == (frames[i] * 256,)
        assert torch.isfinite(b).all() and b.abs().max() > 0.1
        assert not _differ(a, b, f"row {i}'s waveform")
