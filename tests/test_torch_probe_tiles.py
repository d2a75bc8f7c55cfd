"""The wgmma probe kernels' walks, mirrored in Python on the CPU.

#13 (`scores_wgmma`), #10/#12 (`dots_wgmma`) and #11 (`dots_n_wgmma`) in
omnibiote_tpu_torch/ops/csrc/roofline_probes.cu are CUDA kernels, which have
no CPU mode. These tests mirror their arithmetic: the boxes each step of a
CTA loads (at the coordinates the producer thread gives the TMA unit, with
zeros past the tensor map's bounds, as the unit fills them), the fp32
products on those boxes with S rounded to the inputs' dtype where the
kernel rounds it, the output clipped where the TMA store clips it, and the
order in which a persistent CTA walks its work items. The mirrors are held
against the plain versions (`roofline2.scores_plain`, `dots_plain`,
`roofline.dots_n_plain`).
`chip_smoke.py` phase 11 is what proves the kernels themselves, on the card,
against the same plain versions."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import numpy as np
import pytest
import torch

from omnibiote_tpu_torch.probes import roofline, roofline2

D = 128
N_TILE, K_STEP = roofline2.SCORES_N_TILE, roofline2.SCORES_K_STEP
KV_TILE, PANEL = roofline.KERNEL_KV_TILE, 64
RTOL = 1e-5  # fp32 sums of the same products in another order


def _x(B, T, H, seed, n=1, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, B, T, H, D)).astype(np.float32) * 0.1
    return [torch.from_numpy(a).to(dtype) for a in x]


def _box(x, r0, rows, c0, cols):
    """x[r0 : r0 + rows, c0 : c0 + cols] of a 2-D tensor in fp32, zeros past
    its bounds: a TMA box of a 3-D map's batch entry."""
    out = torch.zeros(rows, cols)
    r1, c1 = min(r0 + rows, x.shape[0]), min(c0 + cols, x.shape[1])
    if r1 > r0 and c1 > c0:
        out[:r1 - r0, :c1 - c0] = x[r0:r1, c0:c1].float()
    return out


def _close(got, want, rtol=RTOL):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item(), err


def persistent_walk(n_items, ctas):
    """The items each CTA of a persistent launch takes: item, item + ctas, ...
    from its own index, as both kernels' loops run."""
    return [list(range(c, n_items, ctas)) for c in range(min(ctas, n_items))]


# ---------------------------------------------------------------------------
# #13: scores_wgmma
# ---------------------------------------------------------------------------

def scores_tile_of(tile, n_m, n_n):
    """(batch row, row tile, column tile) of a tile index: columns fastest."""
    return tile // (n_n * n_m), (tile // n_n) % n_m, tile % n_n


def scores_boxes(mt, nt, ks, j0, bm, kt):
    """The boxes k-step ks of tile (mt, nt) loads, as (row, column) corners of
    a batch entry: the q box (bm rows x K_STEP columns of (T, H*D)) and the
    k boxes: one of N_TILE rows x K_STEP columns of (T, H*D), or with kt,
    N_TILE / 64 of K_STEP rows x 64 columns of (H*D, T)."""
    a = (mt * bm, ks * K_STEP)
    if kt:
        b = [(ks * K_STEP, j0 + nt * N_TILE + pn * PANEL) for pn in range(N_TILE // PANEL)]
    else:
        b = [(j0 + nt * N_TILE, ks * K_STEP)]
    return a, b


def scores_walk(q, k, block_kv, kt, bm):
    """scores_wgmma's function walked as its CTAs walk it, in fp32."""
    B, T, H, _ = q.shape
    HD, j0 = H * D, T - block_kv
    x = q.reshape(B, T, HD)
    n_m, n_n = T // bm, -(-HD // N_TILE)
    o = torch.zeros(B, T, HD)
    for tile in range(B * n_m * n_n):
        b, mt, nt = scores_tile_of(tile, n_m, n_n)
        acc = torch.zeros(bm, N_TILE)
        for ks in range(HD // K_STEP):
            (ar, ac), bxs = scores_boxes(mt, nt, ks, j0, bm, kt)
            a = _box(x[b], ar, bm, ac, K_STEP)
            if kt:
                bt = torch.cat([_box(k[b], r, K_STEP, c, PANEL) for r, c in bxs], dim=1)
            else:
                (r, c), = bxs
                bt = _box(k.reshape(B, T, HD)[b], r, N_TILE, c, K_STEP).T
            acc += a @ bt
        cols = min(N_TILE, HD - nt * N_TILE)       # the store clips at H*D
        o[b, mt * bm:(mt + 1) * bm, nt * N_TILE:nt * N_TILE + cols] = acc[:, :cols]
    return o.to(q.dtype).reshape(B, T, H, D)


def test_scores_boxes_literal():
    """The first tile's steps and a column tile past j0, at T = 1024 with
    block_kv = 512 (j0 = 512), 128-row CTAs."""
    assert scores_boxes(0, 0, 0, 512, 128, False) == ((0, 0), [(512, 0)])
    assert scores_boxes(3, 1, 5, 512, 128, False) == ((384, 320), [(768, 320)])
    assert scores_boxes(3, 1, 5, 512, 128, True) == (
        (384, 320), [(320, 768), (320, 832), (320, 896), (320, 960)])


@pytest.mark.parametrize("B,T,H,block_kv,kt,bm", [
    (2, 512, 2, 256, False, 128), (2, 512, 2, 256, True, 64),   # j0 = 256
    (1, 320, 1, 160, False, 64), (1, 320, 1, 160, True, 64),    # j0 = 160, half a column tile
    (1, 384, 3, 384, True, 128),                                # H*D = 384: a ragged column tile
], ids=["kt0-j0", "kt1-j0", "kt0-half", "kt1-half", "kt1-hd384"])
def test_scores_walk_matches_plain(B, T, H, block_kv, kt, bm):
    q, k = _x(B, T, H, seed=T + H, n=2)
    kk = roofline2.transposed_k(k) if kt else k
    kw = kk if kt else k.reshape(B, T, H * D)
    _close(scores_walk(q, kw, block_kv, kt, bm),
           roofline2.scores_plain(q, kk, bm, block_kv, kt))


@pytest.mark.parametrize("kt", [False, True], ids=["kt0", "kt1"])
def test_scores_is_one_gemm_a_batch_row(kt):
    """The library row of #13: o[b] = x[b] . k's columns j0 .. j0 + H*D, one
    torch.matmul, for both layouts of k."""
    B, T, H, block_kv = 2, 512, 2, 256
    q, k = _x(B, T, H, seed=11, n=2)
    HD, j0 = H * D, T - block_kv
    x = q.reshape(B, T, HD)
    if kt:
        kx = roofline2.transposed_k(k)
        want = torch.matmul(x, kx[:, :, j0:j0 + HD])
    else:
        kx = k
        want = torch.matmul(x, k.reshape(B, T, HD)[:, j0:j0 + HD].transpose(1, 2))
    _close(roofline2.scores_plain(q, kx, 128, block_kv, kt).reshape(B, T, HD), want)


# ---------------------------------------------------------------------------
# #10 / #12: dots_wgmma
# ---------------------------------------------------------------------------

def dots_item_of(item, n_qt, H):
    """(batch row, head, q tile) of a work item: q tiles fastest."""
    return item // (n_qt * H), (item // n_qt) % H, item % n_qt


def dots_walk(q, k, v, kt, bq):
    """dots_wgmma's function walked as its CTAs walk it: a work item's q
    tile against 128-row K and V tiles, the last one zero past T."""
    B, T, H, _ = q.shape
    HD = H * D
    x, vx = q.reshape(B, T, HD), v.reshape(B, T, HD)
    n_qt = T // bq
    o = torch.zeros(B, T, HD)
    for item in range(B * H * n_qt):
        b, h, qt = dots_item_of(item, n_qt, H)
        qa = _box(x[b], qt * bq, bq, h * D, D)
        acc = torch.zeros(bq, D)
        for j in range(-(-T // KV_TILE)):
            if kt:      # (H*D, T): 128 head-dim rows x 128 kv columns
                kb = _box(k[b], h * D, D, j * KV_TILE, KV_TILE)
            else:       # (T, H*D): 128 kv rows x 128 head-dim columns
                kb = _box(k.reshape(B, T, HD)[b], j * KV_TILE, KV_TILE, h * D, D).T
            s = (qa @ kb).to(q.dtype).float()
            acc += s @ _box(vx[b], j * KV_TILE, KV_TILE, h * D, D)
        o[b, qt * bq:(qt + 1) * bq, h * D:(h + 1) * D] = acc
    return o.reshape(B, T, H, D)


@pytest.mark.parametrize("T,kt,bq", [(192, False, 64), (192, True, 64), (320, False, 64),
                                     (320, True, 64), (256, True, 128)],
                         ids=["T192-kt0", "T192-kt1", "T320-kt0", "T320-kt1", "T256-kt1"])
def test_dots_walk_matches_plain(T, kt, bq):
    """At T = 192 and 320 the last 128-row kv tile runs past T: its zero rows
    add nothing to either product."""
    B, H = 2, 2
    q, k, v = _x(B, T, H, seed=T, n=3)
    kk = roofline2.transposed_k(k) if kt else k
    kw = kk if kt else k
    _close(dots_walk(q, kw, v, kt, bq), roofline2.dots_plain(q, kk, v, T, 64, kt))


def test_dots_walk_rounds_s_as_the_plain_version():
    """bf16 inputs: S rounded to bf16 before S . V in both, fp32 sums in
    another order, so the two differ by at most the plain version's final
    rounding (2^-8 relative)."""
    q, k, v = _x(1, 192, 2, seed=5, n=3, dtype=torch.bfloat16)
    _close(dots_walk(q, k, v, False, 64), roofline.dots_only_plain(q, k, v, 64, 64),
           rtol=2.0 ** -8)


# ---------------------------------------------------------------------------
# the persistent walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,T,bq,ctas", [(8, 8, 1024, 128, 132), (8, 8, 1024, 64, 132),
                                           (2, 3, 320, 64, 7), (1, 1, 128, 128, 132)])
def test_persistent_dots_walk_covers_each_item_once(B, H, T, bq, ctas):
    n_qt = T // bq
    walks = persistent_walk(B * H * n_qt, ctas)
    seen = [dots_item_of(i, n_qt, H) for w in walks for i in w]
    assert sorted(seen) == [(b, h, qt) for b in range(B) for h in range(H)
                            for qt in range(n_qt)]
    loads = [len(w) for w in walks]
    assert max(loads) - min(loads) <= 1


@pytest.mark.parametrize("B,T,HD,bm,ctas", [(8, 1024, 1024, 128, 132), (2, 320, 384, 64, 3)])
def test_persistent_scores_walk_covers_each_tile_once(B, T, HD, bm, ctas):
    n_m, n_n = T // bm, -(-HD // N_TILE)
    walks = persistent_walk(B * n_m * n_n, ctas)
    seen = sorted(scores_tile_of(t, n_m, n_n) for w in walks for t in w)
    assert seen == [(b, mt, nt) for b in range(B) for mt in range(n_m) for nt in range(n_n)]
    loads = [len(w) for w in walks]
    assert max(loads) - min(loads) <= 1


# ---------------------------------------------------------------------------
# #11: dots_n_wgmma
# ---------------------------------------------------------------------------

def dots_n_item_of(item, n_rows, H, br, block_q):
    """(batch row, head, first row of the q tile, first kv-local row) of a
    work item of br kv-local rows: row blocks fastest, then heads."""
    row = item % n_rows * br
    q0 = row // block_q * block_q
    return item // (n_rows * H), (item // n_rows) % H, q0, row - q0


def dots_n_rows(item, T, H, br, block_q):
    """The output rows (b, h, t) a work item writes: its br kv-local rows r
    of its q tile, t = q0 + r."""
    b, h, q0, rb = dots_n_item_of(item, T // br, H, br, block_q)
    return [(b, h, q0 + rb + r) for r in range(br)]


def dots_n_walk(q, k, v, block_q, block_kv, n_dots, br, chunk):
    """dots_n_wgmma's function walked as its CTAs walk it: per work item and
    kv tile, the K and V boxes of the item's rows r; per chunk of the q tile
    the Q box (and with 4 products V's box at the same offsets in the kv
    tile), both score products in one fp32 accumulator, S^T rounded once to
    the inputs' dtype, S^T·Q_i (+ S^T·V_i) added to the item's fp32
    accumulator; o written once, rounded."""
    B, T, H, _ = q.shape
    HD = H * D
    x, kx, vx = (t.reshape(B, T, HD) for t in (q, k, v))
    n_rows = T // br
    o = torch.zeros(B, T, HD)
    for item in range(B * H * n_rows):
        b, h, q0, rb = dots_n_item_of(item, n_rows, H, br, block_q)
        acc = torch.zeros(br, D)
        for kt in range(T // block_kv):
            r0 = kt * block_kv
            kr = _box(kx[b], r0 + rb, br, h * D, D)
            vr = _box(vx[b], r0 + rb, br, h * D, D)
            for c in range(block_q // chunk):
                qi = _box(x[b], q0 + c * chunk, chunk, h * D, D)
                st = kr @ qi.T
                st += vr @ qi.T
                st = st.to(q.dtype).float()
                acc += st @ qi
                if n_dots == 4:
                    acc += st @ _box(vx[b], r0 + c * chunk, chunk, h * D, D)
        o[b, q0 + rb:q0 + rb + br, h * D:(h + 1) * D] = acc
    return o.to(q.dtype).reshape(B, T, H, D)


def test_dots_n_chunk_divides_block_q():
    """128-row chunks where block_q allows, else 64: a chunk past the q tile
    would load the next tile's rows, not zeros."""
    assert roofline.DOTS_N_CHUNK == 128 and roofline.DOTS_N_CHUNK_NARROW == 64
    for bq, want in ((64, 64), (128, 128), (192, 64), (256, 128), (512, 128), (320, 64)):
        assert roofline.dots_n_chunk(bq) == want
        assert bq % roofline.dots_n_chunk(bq) == 0


@pytest.mark.parametrize("B,T,H,bq,bkv,n_dots,br", [
    (1, 512, 2, 256, 256, 4, 128), (1, 512, 2, 256, 256, 4, 64),
    (1, 512, 2, 128, 256, 3, 128), (1, 512, 1, 256, 512, 3, 64),
    (2, 384, 1, 64, 96, 3, 64),     # a kv tile of 96 rows, 64-row chunks
    (1, 384, 2, 192, 192, 4, 64),   # block_q 192: 64-row chunks
    (1, 384, 2, 128, 192, 3, 128),  # a kv tile of 192 rows, one 128-row chunk
    (2, 256, 2, 128, 128, 3, 64),
], ids=["4dot-br128", "4dot-br64", "3dot-bq<bkv-br128", "3dot-bkv=T", "3dot-bkv96",
        "4dot-bq192", "3dot-bkv192-br128", "3dot-B2"])
def test_dots_n_walk_matches_plain(B, T, H, bq, bkv, n_dots, br):
    q, k, v = _x(B, T, H, seed=T + bq + n_dots, n=3)
    _close(dots_n_walk(q, k, v, bq, bkv, n_dots, br, roofline.dots_n_chunk(bq)),
           roofline.dots_n_plain(q, k, v, bq, bkv, n_dots))


def test_dots_n_walk_rounds_s_as_the_plain_version():
    """bf16 inputs: S^T rounded to bf16 once in both, fp32 sums in another
    order, so the two differ by at most the plain version's final rounding
    (2^-8 relative)."""
    q, k, v = _x(1, 256, 2, seed=9, n=3, dtype=torch.bfloat16)
    _close(dots_n_walk(q, k, v, 128, 128, 4, 128, roofline.dots_n_chunk(128)),
           roofline.dots_n_plain(q, k, v, 128, 128, 4), rtol=2.0 ** -8)


@pytest.mark.parametrize("B,H,T,bq,br,ctas", [
    (8, 8, 1024, 512, 128, 132), (8, 8, 1024, 512, 64, 132), (2, 3, 384, 192, 64, 7),
    (2, 2, 384, 64, 64, None)],
    ids=["probes-br128", "probes-br64", "ragged", "a-CTA-an-item"])
def test_dots_n_walk_writes_each_row_once(B, H, T, bq, br, ctas):
    """Persistent (ctas CTAs) or one CTA a work item (None): every output
    row of every (b, h) once, and a CTA's items balanced within one."""
    n_items = B * H * (T // br)
    walks = persistent_walk(n_items, ctas or n_items)
    rows = [r for w in walks for i in w for r in dots_n_rows(i, T, H, br, bq)]
    assert sorted(rows) == [(b, h, t) for b in range(B) for h in range(H) for t in range(T)]
    loads = [len(w) for w in walks]
    assert max(loads) - min(loads) <= 1
