"""The cost functions against hand counts."""

from benchmark.costs import flops, peaks
from benchmark.harness import cells


def _cnc(name="nerf_synthetic"):
    return cells.workload(name + ".train_rate")["cfg"]["cnc_config"]


def test_field_macs_at_the_published_widths():
    base, head = flops.field_macs(_cnc()["model"])
    assert base == 159 * 160 + 160 * 40          # 12x4 + 3x4x4 + 63 -> 160 -> 1 + 39
    assert head == 55 * 160 + 160 * 160 + 160 * 3  # 16 + 39 -> 160 -> 160 -> 3
    assert base + head == 66_720


def test_context_macs():
    ent = _cnc()["entropy"]
    assert flops.ctx3d_macs(ent) == 13 * 32 + 32 * 32 + 32 * 4 == 1_568
    # level 1 of the planes: F (min(1, 3) + 1) + 1 -> F
    assert flops.ctx2d_macs(ent, 1) == (4 * 2 + 1) * 4
    assert flops.ctx2d_macs(ent, 3) == (4 * 4 + 1) * 4


def test_window_flops_by_hand():
    cnc = _cnc()
    counts = {"samples": 1000, "ctx_rows": 10, "rate_steps": 2, "occ_updates": 1}
    got = flops.train_window(cnc, {1: 5, 2: 7}, counts)
    macs = (3 * (66_720 * 1000 + 1_568 * 10 + 2 * 3 * (36 * 5 + 52 * 7))
            + 31_840 * 2 * (128 ** 3 // 4))
    assert got == 2.0 * macs
    assert flops.view(cnc, 10) == 2.0 * 66_720 * 10


def test_peaks():
    assert peaks.F32_FLOPS == 67e12 and peaks.HBM_BYTES == 3.35e12


def test_unique_rows_counted_once():
    import torch
    from benchmark.costs import kernels
    # a dense 2D level of resolution 6 (interior lattice 1..4) at offset 8
    pts = torch.tensor([[0.5, 0.5], [0.51, 0.52], [0.0, 0.0], [1.5, 0.5]])
    # (0.5, 0.5) and (0.51, 0.52) share the cell at lattice (2, 2): its four
    # corners once; (0, 0) keeps only its corner (1, 1); (1.5, .5) is outside
    assert kernels.rows_touched(pts, [6], [8, 8 + 36]) == 4 + 1
    want = {8 + x + 6 * y for x, y in ((2, 2), (3, 2), (2, 3), (3, 3), (1, 1))}
    assert len(want) == 5
    # a hashed 3D level: two corners of one point, by the hash's formula
    p = torch.tensor([[0.5, 0.5, 0.5]])
    r, size = 130, 1 << 10                   # 130^3 > 2^10: hashed
    got = kernels.rows_touched(p, [r], [0, size])
    x = 0.5 * (r - 2) + 0.5                  # 64.5 -> cell 64, corners 64 and 65 an axis
    rows = set()
    for c in range(8):
        cc = [64 + ((c >> a) & 1) for a in range(3)]
        h = cc[0] ^ ((cc[1] * 2654435761) & 0xFFFFFFFF) ^ ((cc[2] * 805459861) & 0xFFFFFFFF)
        rows.add(h & (size - 1))
    assert x == 64.5 and got == len(rows)


def test_encode_and_composite_bytes():
    from benchmark.costs import kernels
    io, ops = kernels.encode(10, 3, 12, 4, 100)
    assert io == 10 * 3 * 4 + 10 * 48 * 4 + 100 * 16 and ops == 10 * 12 * 8 * 11
    io, _ = kernels.composite(7, 2, carried=True, backward=True)
    assert io == 7 * 25 + 2 * 20 + 2 * 4 + 7 * 16
