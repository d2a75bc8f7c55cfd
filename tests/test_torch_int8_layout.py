"""The int8 attention kernel's layout and conversions, on the CPU.

The CUDA kernel (ops/csrc/int8_flash_fwd.cu) runs P8 · V8 as an s8 wgmma
whose A operand comes from the score accumulators' registers. A thread's
accumulators hold score columns 8n + 2t, 8n + 2t + 1 of each 8-column
block n, while its A register j of a 32-deep k-step holds the consecutive
k bytes 4t..4t+3 (j = 0, 1) or 16+4t..16+4t+3 (j = 2, 3), rows g (j even)
or g + 8 (j odd) of its warp's 16 (g = lane / 4, t = lane % 4; the PTX ISA's
wgmma register fragments for .s8). The prologue writes V8ᵀ's kv axis in
the order that makes a thread's own bytes, packed in register order, the
right k bytes. These tests emulate that packing in plain PyTorch and pin
the permutation and the two exact conversions the kernel uses in place of
int → float and rint on every (q, k) pair.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import numpy as np
import pytest
import torch

from omnibiote_tpu_torch.ops import int8_attention as i8

MAGIC = 12582912.0       # 1.5 · 2^23
MAGIC_BITS = 0x4B400000  # its fp32 bits
S_MAX = 128 * 127 * 127  # |q8 · k8| at D = 128


def _rand_int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))


def test_kernel_kv_order_is_a_permutation_inside_each_32_block():
    order = i8.kernel_kv_order(640)
    assert sorted(order.tolist()) == list(range(640))
    blocks = order.view(-1, 32)
    assert torch.equal(blocks // 32, torch.arange(20)[:, None].expand(20, 32))
    # lane t's four bytes of k-step half 0: its columns 2t, 2t+1, 8+2t, 9+2t
    assert order[:8].tolist() == [0, 1, 8, 9, 2, 3, 10, 11]
    assert order[16:20].tolist() == [16, 17, 24, 25]
    with pytest.raises(ValueError, match="multiple of 32"):
        i8.kernel_kv_order(100)


@pytest.mark.parametrize("T", [128, 640])
def test_kernel_layout_round_trips(T):
    rng = np.random.default_rng(T)
    q8, k8 = _rand_int8(rng, (2, 3, T, 128)), _rand_int8(rng, (2, 3, T, 128))
    v8t = _rand_int8(rng, (2, 3, 128, T))
    sq, sk = torch.rand(2, 3, T), torch.rand(2, 3, T)
    sv = torch.rand(2, 3, 128)
    six = (q8, sq, k8, sk, v8t, sv)
    kern = i8.int8_kernel_layout(*six)
    for a, b in zip(kern[:4] + kern[5:], six[:4] + six[5:]):
        assert a is b
    assert not torch.equal(kern[4], v8t)
    assert torch.equal(kern[4], v8t[..., i8.kernel_kv_order(T)])
    back = i8.int8_natural_layout(*kern)
    assert all(torch.equal(a, b) for a, b in zip(back, six))


def _accumulator_coords():
    """(row, column) of register 4n + e of thread `tid` of a 64 x 128 wgmma
    accumulator: warp w = tid / 32 holds rows 16w.., g = lane / 4, t = lane % 4."""
    tid = np.arange(128)[:, None, None]
    n = np.arange(16)[None, :, None]
    e = np.arange(4)[None, None, :]
    w, lane = tid // 32, tid % 32
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1)


def _a_fragment_coords():
    """(row, k) of byte i of A register j of thread `tid`, one 32-deep
    k-step of a 64-row s8 wgmma: rows g (j even) or g + 8 (j odd), k bytes
    4t + i (j < 2) or 16 + 4t + i."""
    tid = np.arange(128)[:, None, None]
    j = np.arange(4)[None, :, None]
    i = np.arange(4)[None, None, :]
    w, lane = tid // 32, tid % 32
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * (j & 1), 16 * (j >> 1) + 4 * t + i


def _packed_operand(p8, T):
    """The A operand of P8 · V8 as the kernel's threads build it: each
    128-wide kv tile's scores in accumulator order, each thread packing
    its own bytes into registers (blocks 4kk, 4kk + 1 into registers 0 and
    1, blocks 4kk + 2, 4kk + 3 into 2 and 3: `pack_p8` of the kernel), then
    placed where the hardware reads those registers."""
    rows, cols = _accumulator_coords()
    a_rows, a_k = _a_fragment_coords()
    A = torch.zeros_like(p8)
    for j0 in range(0, T, 128):
        acc = p8[:, j0:j0 + 128][rows, cols]          # (thread, block n, element e)
        for kk in range(4):
            lo = [acc[:, 4 * kk + b, 0:2] for b in range(4)]   # row g pairs
            hi = [acc[:, 4 * kk + b, 2:4] for b in range(4)]   # row g + 8 pairs
            regs = torch.stack([torch.cat(lo[0:2], 1), torch.cat(hi[0:2], 1),
                                torch.cat(lo[2:4], 1), torch.cat(hi[2:4], 1)], 1)
            A[a_rows, j0 + 32 * kk + a_k] = regs         # (thread, register j, byte i)
    return A


@pytest.mark.parametrize("T", [128, 640])
def test_packed_p8_against_the_permuted_v_is_the_natural_product(T):
    """The kernel's per-thread packing of p8 against its permuted V8ᵀ gives
    the int32 p8 · v8 of the natural order, exactly; packing against the
    natural V8ᵀ does not."""
    rng = np.random.default_rng(T + 1)
    p8 = torch.from_numpy(rng.integers(0, 128, size=(64, T)).astype(np.int32))
    v8t = _rand_int8(rng, (1, 1, 128, T))
    v8t_kernel = i8.int8_kernel_layout(None, None, None, None, v8t, None)[4]
    A = _packed_operand(p8, T)
    want = p8 @ v8t[0, 0].int().T
    assert torch.equal(A @ v8t_kernel[0, 0].int().T, want)
    assert not torch.equal(A @ v8t[0, 0].int().T, want)


def test_int_to_float_by_an_integer_add_is_exact():
    """float(s) = bits(s + 0x4B400000) - 1.5 · 2^23 for every score a D = 128
    product can give, |s| <= 128 · 127² < 2^22."""
    s = torch.cat([torch.arange(-S_MAX, S_MAX + 1, 97, dtype=torch.int32),
                   torch.arange(-4096, 4097, dtype=torch.int32),
                   torch.tensor([-S_MAX, S_MAX, 0, 1, -1], dtype=torch.int32)])
    got = (s + MAGIC_BITS).view(torch.float32) - torch.tensor(MAGIC, dtype=torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got, s.float())


def test_rint_by_a_float_add_is_round_half_even():
    """rint(x) = bits(x + 1.5 · 2^23) - 0x4B400000, half to even, for every
    x = p · 127 (p in [0, 1], fp32 products) and every quotient in
    [-127.5, 127.5], the exact .5 ties included; the low byte is rint(x)'s
    int8 byte."""
    p = torch.linspace(0.0, 1.0, 1_000_001, dtype=torch.float32)
    ties = torch.arange(-128, 128, dtype=torch.float32) + 0.5
    near = torch.cat([torch.nextafter(ties, torch.tensor(-200.0)),
                      torch.nextafter(ties, torch.tensor(200.0))])
    x = torch.cat([p * torch.tensor(127.0), ties, near,
                   torch.linspace(-127.5, 127.5, 255_001, dtype=torch.float32)])
    bits = (x + torch.tensor(MAGIC, dtype=torch.float32)).view(torch.int32)
    want = torch.round(x)                        # half to even
    assert torch.equal((bits - MAGIC_BITS).float(), want)
    assert torch.equal((bits & 0xFF).to(torch.uint8).view(torch.int8),
                       want.to(torch.int32).to(torch.int8))
    assert (want[x == 0.5] == 0).all() and (want[x == 1.5] == 2).all()
    assert (want[x == -2.5] == -2).all()
