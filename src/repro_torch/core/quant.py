"""Quantisation and sub-byte containers for the QNN datapath, in PyTorch.

* ``quantize`` / ``dequantize`` — symmetric per-channel int codes with
  ``scale = max(amax / qmax, 1e-12)`` and round-half-to-even;
* ``pack_codes`` / ``unpack_codes`` — two 4-bit (int4x2) or four 2-bit
  (int2x4) codes per uint8 byte along one axis, lowest field = lowest index,
  sign-extended on the way back as ``(c ^ s) - s``;
* ``PackedTensor`` — a bit-packed container plus its logical shape;
* ``fake_quant`` — quantise-dequantise with a straight-through gradient
  (quantisation-aware training).

Byte for byte the layout of ``repro.core.quant``: a container written by one
package unpacks to the same codes in the other.  Every function works on
tensors of any device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = [
    "PACKED_CONTAINER",
    "PACKED_CONTAINER_INT2",
    "PackedTensor",
    "QuantizedTensor",
    "codes_per_byte",
    "container_tag",
    "dequantize",
    "fake_quant",
    "pack_codes",
    "pack_int4",
    "pack_quantized",
    "pick_pack_axis",
    "qmax",
    "quantize",
    "unpack_codes",
    "unpack_int4",
]

PACKED_CONTAINER = "int4x2"
PACKED_CONTAINER_INT2 = "int2x4"


def codes_per_byte(bits: int) -> int:
    """Codes a uint8 byte holds at ``bits`` code width (1 for int8)."""
    if bits <= 2:
        return 4
    if bits <= 4:
        return 2
    return 1


def container_tag(per_byte: int) -> str:
    """Container tag for a packing density (codes per byte)."""
    if per_byte == 4:
        return PACKED_CONTAINER_INT2
    if per_byte == 2:
        return PACKED_CONTAINER
    raise ValueError(f"no packed container holds {per_byte} codes/byte")


def qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


@dataclasses.dataclass
class QuantizedTensor:
    values: torch.Tensor  # int8 codes
    scales: torch.Tensor  # f32, per-channel along `axis`
    axis: int
    bits: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.values.shape)


def quantize(w: torch.Tensor, bits: int = 8, axis: int = -1) -> QuantizedTensor:
    """Symmetric per-channel quantisation along ``axis`` (out-channels)."""
    w = torch.as_tensor(w).to(torch.float32)
    axis = axis % w.ndim
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    amax = w.abs().amax(dim=reduce_axes, keepdim=True)
    scale = torch.clamp_min(amax / qmax(bits), 1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax(bits), qmax(bits))
    return QuantizedTensor(values=q.to(torch.int8), scales=scale.squeeze(),
                           axis=axis, bits=bits)


def fake_quant(w: torch.Tensor, bits: int = 8, axis: int = -1) -> torch.Tensor:
    """Quantise-dequantise with a straight-through gradient.

    forward:  round(w / s).clip * s       backward:  identity
    """
    axis = axis % w.dim()
    reduce_axes = tuple(i for i in range(w.dim()) if i != axis)
    # an empty dim list would reduce every axis in torch, none in JAX
    amax = w.abs().amax(dim=reduce_axes, keepdim=True) if reduce_axes \
        else w.abs()
    scale = torch.clamp_min(amax / qmax(bits), 1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax(bits), qmax(bits)) * scale
    return w + (q - w).detach()


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    shape = [1] * qt.values.ndim
    shape[qt.axis] = qt.values.shape[qt.axis]
    return qt.values.to(torch.float32) * qt.scales.reshape(shape)


# ------------------------------------------- sub-byte code bit-packing


def pack_codes(values: torch.Tensor, axis: int = 0, bits: int = 4) -> torch.Tensor:
    """Pack sub-byte codes ``codes_per_byte(bits)``-per-byte along ``axis``.

    Code j of each byte occupies bits ``[j*w, (j+1)*w)`` with
    ``w = 8 // codes_per_byte(bits)``.  An axis that is not a multiple of
    the code count is zero-padded; :func:`unpack_codes` slices the pad off.
    """
    per_byte = codes_per_byte(bits)
    if per_byte == 1:
        raise ValueError(f"pack_codes needs <=4-bit codes, got bits={bits}")
    width = 8 // per_byte
    v = torch.as_tensor(values)
    axis = axis % v.ndim
    rem = v.shape[axis] % per_byte
    if rem:
        pad_shape = list(v.shape)
        pad_shape[axis] = per_byte - rem
        v = torch.cat([v, v.new_zeros(pad_shape)], dim=axis)
    fields = v.to(torch.uint8) & ((1 << width) - 1)
    shape = list(fields.shape)
    split = shape[:axis] + [shape[axis] // per_byte, per_byte] + shape[axis + 1:]
    fields = fields.reshape(split)
    out = fields.select(axis + 1, 0).clone()
    for j in range(1, per_byte):
        out |= fields.select(axis + 1, j) << (j * width)
    return out


def unpack_codes(packed: torch.Tensor, length: int, axis: int = 0,
                 bits: int = 4) -> torch.Tensor:
    """Exact inverse of :func:`pack_codes`: uint8 container -> int8 codes.

    ``length`` is the logical (pre-padding) size of ``axis``.
    """
    per_byte = codes_per_byte(bits)
    if per_byte == 1:
        raise ValueError(f"unpack_codes needs <=4-bit codes, got bits={bits}")
    width = 8 // per_byte
    p = torch.as_tensor(packed)
    axis = axis % p.ndim
    mask = (1 << width) - 1
    parts = [(p >> (j * width)) & mask for j in range(per_byte)]
    both = torch.stack(parts, dim=axis + 1)
    shape = list(p.shape)
    shape[axis] *= per_byte
    both = both.reshape(shape)                    # low field first
    sign = 1 << (width - 1)
    codes = (both ^ sign).to(torch.int8) - sign
    if int(length) != shape[axis]:
        codes = codes.narrow(axis, 0, int(length))
    return codes


def pack_int4(values: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack int4 codes two per byte: even index low nibble, odd high."""
    return pack_codes(values, axis=axis, bits=4)


def unpack_int4(packed: torch.Tensor, length: int, axis: int = 0) -> torch.Tensor:
    """Exact inverse of :func:`pack_int4` (``(n ^ 8) - 8`` sign extension)."""
    return unpack_codes(packed, length, axis=axis, bits=4)


def pick_pack_axis(shape: Tuple[int, ...], preferred: int = 0,
                   per_byte: int = 2) -> int:
    """``preferred`` when its length divides into whole bytes, else the
    first axis that does, else ``preferred`` with pad codes."""
    preferred = preferred % len(shape)
    if shape[preferred] % per_byte == 0:
        return preferred
    for i, n in enumerate(shape):
        if n % per_byte == 0:
            return i
    return preferred


@dataclasses.dataclass
class PackedTensor:
    """Bit-packed sub-byte storage container.

    ``data`` is the uint8 buffer (``per_byte`` codes per byte along
    ``axis``: 2 for int4x2, 4 for int2x4); ``shape`` is the logical code
    shape.  For a quantised-linear payload ``scales`` holds the
    per-output-channel scales ``(N,)``; inside a
    :class:`repro_torch.core.sparsity.CompressedLinear` it stays None.
    """

    data: torch.Tensor
    shape: Tuple[int, ...]
    axis: int = 0
    scales: Optional[torch.Tensor] = None
    bits: int = 4
    per_byte: int = 2

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)
        if self.per_byte not in (2, 4):
            raise ValueError(
                f"PackedTensor per_byte must be 2 (int4x2) or 4 (int2x4), "
                f"got {self.per_byte}")
        expect = list(self.shape)
        ax = self.axis % len(expect)
        expect[ax] = -(-expect[ax] // self.per_byte)
        if tuple(self.data.shape) != tuple(expect):
            raise ValueError(
                f"PackedTensor container shape {tuple(self.data.shape)} does "
                f"not match logical shape {self.shape} packed along axis "
                f"{self.axis} at {self.per_byte} codes/byte "
                f"(expected {tuple(expect)})")

    @property
    def container(self) -> str:
        return container_tag(self.per_byte)

    @property
    def code_width(self) -> int:
        return 8 // self.per_byte

    @property
    def container_bytes(self) -> int:
        """Bytes held in memory (buffer + scales)."""
        b = int(self.data.numel())
        if self.scales is not None:
            b += int(self.scales.numel() * self.scales.element_size())
        return b

    def unpack(self) -> torch.Tensor:
        return unpack_codes(self.data, self.shape[self.axis % len(self.shape)],
                            axis=self.axis, bits=self.code_width)

    def dequantize(self) -> torch.Tensor:
        if self.scales is None:
            raise ValueError("PackedTensor has no scales to dequantize with")
        return self.unpack().to(torch.float32) \
            * self.scales.reshape((1,) * (len(self.shape) - 1) + (-1,))

    def to_quantized(self) -> QuantizedTensor:
        if self.scales is None:
            raise ValueError("PackedTensor has no scales")
        return QuantizedTensor(values=self.unpack(), scales=self.scales,
                               axis=len(self.shape) - 1, bits=self.bits)


def pack_quantized(qt: QuantizedTensor, preferred_axis: int = 0) -> PackedTensor:
    """Pack a sub-byte :class:`QuantizedTensor` into its container: <=2-bit
    codes four per byte (int2x4), 3/4-bit two per byte (int4x2), along
    :func:`pick_pack_axis`.  Scales must be per last axis."""
    if qt.bits > 4:
        raise ValueError(f"pack_quantized needs <=4-bit codes, got {qt.bits}")
    per_byte = codes_per_byte(qt.bits)
    width = 8 // per_byte
    ax = pick_pack_axis(tuple(qt.values.shape), preferred_axis,
                        per_byte=per_byte)
    return PackedTensor(
        data=pack_codes(qt.values, axis=ax, bits=width),
        shape=tuple(qt.values.shape), axis=ax,
        scales=qt.scales.reshape(qt.values.shape[-1]), bits=qt.bits,
        per_byte=per_byte)
