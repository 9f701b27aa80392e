"""Port containers vs the JAX reference: quantisation codes and scales,
sub-byte packing, patterns and compressed linears — byte for byte."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quant as jq  # noqa: E402
from repro.core import sparsity as js  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core import sparsity as ts  # noqa: E402


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------ quantisation


@pytest.mark.parametrize("bits,axis,shape", [(8, 1, (16, 8)), (4, 1, (32, 24)),
                                             (2, 0, (12, 10)), (4, -1, (3, 5, 7))])
def test_quantize_codes_and_scales_match_reference(bits, axis, shape):
    w = np.random.default_rng(bits).normal(size=shape).astype(np.float32)
    w[0] = 0.0  # an all-zero slice exercises the 1e-12 scale floor
    a, b = jq.quantize(w, bits, axis=axis), tq.quantize(torch.from_numpy(w),
                                                        bits, axis=axis)
    np.testing.assert_array_equal(_np(b.values), np.asarray(a.values))
    np.testing.assert_array_equal(_np(b.scales), np.asarray(a.scales))
    assert b.axis == a.axis and b.bits == a.bits
    np.testing.assert_array_equal(_np(tq.dequantize(b)),
                                  np.asarray(jq.dequantize(a)))


def test_quantize_rounds_half_to_even():
    # codes of exact .5 multiples of the scale round to the even neighbour
    w = torch.tensor([[7.0], [2.5], [-1.5], [0.5]])
    q = tq.quantize(w, 4, axis=1)
    assert float(q.scales) == 1.0
    assert q.values[:, 0].tolist() == [7, 2, -2, 0]


def test_qmax_codes_per_byte_and_tags():
    for bits in (2, 3, 4, 8):
        assert tq.qmax(bits) == jq.qmax(bits)
        assert tq.codes_per_byte(bits) == jq.codes_per_byte(bits)
    assert tq.PACKED_CONTAINER == "int4x2"
    assert tq.PACKED_CONTAINER_INT2 == "int2x4"
    assert tq.container_tag(2) == "int4x2" and tq.container_tag(4) == "int2x4"
    with pytest.raises(ValueError, match="codes/byte"):
        tq.container_tag(3)


# ----------------------------------------------------------------- packing


def test_int4x2_byte_layout_hand_computed():
    codes = np.array([[1, -2], [-7, 7], [0, -8], [5, 3]], np.int8)
    expect = ((codes[1::2].astype(np.uint8) & 0xF) << 4) \
        | (codes[0::2].astype(np.uint8) & 0xF)
    packed = tq.pack_codes(torch.from_numpy(codes), axis=0, bits=4)
    np.testing.assert_array_equal(_np(packed), expect)
    np.testing.assert_array_equal(_np(tq.pack_int4(torch.from_numpy(codes), 0)),
                                  expect)


def test_int2x4_byte_layout_hand_computed():
    codes = np.array([1, -2, 0, -1, 1, 1, -2, 0], np.int8)
    u = codes.astype(np.uint8) & 0x3
    expect = u[0::4] | (u[1::4] << 2) | (u[2::4] << 4) | (u[3::4] << 6)
    np.testing.assert_array_equal(
        _np(tq.pack_codes(torch.from_numpy(codes), axis=0, bits=2)), expect)


@pytest.mark.parametrize("bits,lo,hi", [(4, -8, 8), (2, -2, 2)])
@pytest.mark.parametrize("shape,axis", [((6, 5), 0), ((7, 4), 0), ((3, 9), 1),
                                        ((2, 5, 6), -1)])
def test_pack_unpack_match_reference(bits, lo, hi, shape, axis):
    codes = np.random.default_rng(len(shape)).integers(
        lo, hi, size=shape).astype(np.int8)
    a = np.asarray(jq.pack_codes(jnp.asarray(codes), axis=axis, bits=bits))
    b = tq.pack_codes(torch.from_numpy(codes), axis=axis, bits=bits)
    assert b.dtype == torch.uint8
    np.testing.assert_array_equal(_np(b), a)
    n = shape[axis]
    np.testing.assert_array_equal(
        _np(tq.unpack_codes(b, n, axis=axis, bits=bits)), codes)
    np.testing.assert_array_equal(
        _np(tq.unpack_codes(b, n, axis=axis, bits=bits)),
        np.asarray(jq.unpack_codes(jnp.asarray(a), n, axis=axis, bits=bits)))


def test_pack_rejects_8bit_codes():
    with pytest.raises(ValueError, match="<=4-bit"):
        tq.pack_codes(torch.zeros(4, dtype=torch.int8), bits=8)
    with pytest.raises(ValueError, match="<=4-bit"):
        tq.unpack_codes(torch.zeros(4, dtype=torch.uint8), 4, bits=8)


@pytest.mark.parametrize("shape,preferred,per_byte",
                         [((4, 6), 0, 2), ((5, 6), 0, 2), ((5, 7), 0, 2),
                          ((6, 8), 0, 4), ((5, 3), 1, 4)])
def test_pick_pack_axis_matches_reference(shape, preferred, per_byte):
    assert tq.pick_pack_axis(shape, preferred, per_byte) \
        == jq.pick_pack_axis(shape, preferred, per_byte)


@pytest.mark.parametrize("bits,shape", [(4, (8, 6)), (4, (7, 6)), (2, (8, 5)),
                                        (3, (5, 7))])
def test_pack_quantized_matches_reference(bits, shape):
    w = np.random.default_rng(bits).normal(size=shape).astype(np.float32)
    a = jq.pack_quantized(jq.quantize(w, bits, axis=1))
    b = tq.pack_quantized(tq.quantize(torch.from_numpy(w), bits, axis=1))
    assert (b.axis, b.per_byte, b.bits, b.shape) == (a.axis, a.per_byte,
                                                       a.bits, a.shape)
    np.testing.assert_array_equal(_np(b.data), np.asarray(a.data))
    np.testing.assert_array_equal(_np(b.scales), np.asarray(a.scales))
    assert b.container_bytes == a.container_bytes
    np.testing.assert_array_equal(_np(b.dequantize()), np.asarray(a.dequantize()))
    np.testing.assert_array_equal(_np(b.to_quantized().values),
                                  np.asarray(a.to_quantized().values))


def test_packed_tensor_rejects_bad_container():
    with pytest.raises(ValueError, match="does not match logical shape"):
        tq.PackedTensor(data=torch.zeros((3, 4), dtype=torch.uint8),
                        shape=(8, 4), axis=0)
    with pytest.raises(ValueError, match="per_byte"):
        tq.PackedTensor(data=torch.zeros((4, 4), dtype=torch.uint8),
                        shape=(8, 4), axis=0, per_byte=3)


# ---------------------------------------------------------------- patterns


def _mask(K, N, block, density, seed):
    rng = np.random.default_rng(seed)
    bm = rng.random((K // block[0], N // block[1])) < density
    m = np.kron(bm, np.ones(block, bool)) & (rng.random((K, N)) < 0.7)
    return m


@pytest.mark.parametrize("block,density", [((8, 4), 0.5), ((4, 8), 0.0),
                                           ((16, 8), 1.0)])
def test_patterns_match_reference(block, density):
    mask = _mask(32, 32, block, density, seed=3)
    a, b = js.pattern_from_mask(mask, block), ts.pattern_from_mask(mask, block)
    for f in ("bitmap", "block_rows", "block_cols"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (a.nnz, a.meta_bytes, a.n_blocks_present) == \
        (b.nnz, b.meta_bytes, b.n_blocks_present)
    assert b.block_rows.dtype == np.int16


def test_shared_pattern_matches_reference():
    a = js.shared_pattern(64, 48, (8, 8), 0.25)
    b = ts.shared_pattern(64, 48, (8, 8), 0.25)
    np.testing.assert_array_equal(a.bitmap, b.bitmap)
    np.testing.assert_array_equal(a.block_rows, b.block_rows)
    with pytest.raises(TypeError, match="tuple"):
        ts.shared_pattern(64, 48, [8, 8], 0.25)


@pytest.mark.parametrize("bits,pack,block", [
    (8, False, (8, 4)), (4, False, (8, 4)), (4, True, (8, 4)),
    (4, True, (5, 4)), (2, True, (8, 4)), (2, True, (6, 4)), (None, False, (8, 4)),
])
def test_compress_matches_reference(bits, pack, block):
    K, N = 120, 16
    rng = np.random.default_rng(7)
    w = rng.normal(size=(K, N)).astype(np.float32)
    mask = _mask(K, N, block, 0.6, seed=5)
    kw = {}
    if bits is not None:
        scales = np.asarray(jq.quantize(w * mask, bits, axis=1).scales)
        kw = dict(quant_scales=scales, quant_bits=bits, pack=pack)
    a = js.compress(w, mask, block, dtype=jnp.float32, **kw)
    b = ts.compress(w, mask, block, dtype=torch.float32, **kw)
    assert a.packed == b.packed and a.bits == b.bits
    if a.packed:
        assert (b.blocks.axis, b.blocks.per_byte) == (a.blocks.axis,
                                                      a.blocks.per_byte)
        np.testing.assert_array_equal(_np(b.blocks.data),
                                      np.asarray(a.blocks.data))
    else:
        np.testing.assert_array_equal(_np(b.blocks), np.asarray(a.blocks))
    if bits is not None:
        np.testing.assert_array_equal(_np(b.scales), np.asarray(a.scales))
    assert b.storage_bytes == a.storage_bytes
    np.testing.assert_array_equal(_np(ts.decompress(b)),
                                  np.asarray(js.decompress(a)))
    np.testing.assert_array_equal(_np(b.block_values()),
                                  np.asarray(a.block_values()))


def test_compress_forced_pattern_and_errors():
    K, N, block = 16, 8, (8, 4)
    w = np.ones((K, N), np.float32)
    own = np.zeros((K, N), bool)
    own[:8, :4] = True
    forced = ts.pattern_from_bitmap((K, N), block, np.ones((2, 2), bool))
    cl = ts.compress(w, own, block, pattern=forced, dtype=torch.float32)
    assert cl.pattern.n_blocks_present == 4 and cl.pattern.nnz == 32
    ref = js.compress(w, own, block, dtype=jnp.float32,
                      pattern=js.pattern_from_bitmap((K, N), block,
                                                     np.ones((2, 2), bool)))
    np.testing.assert_array_equal(_np(cl.blocks), np.asarray(ref.blocks))
    with pytest.raises(ValueError, match="quantised"):
        ts.compress(w, own, block, pack=True)
    with pytest.raises(ValueError, match="<=4-bit"):
        ts.compress(w, own, block, quant_scales=np.ones(N, np.float32),
                    quant_bits=8, pack=True)
