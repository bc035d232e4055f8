"""The bound and FLOP formulas against counts made by hand."""
import numpy as np
import pytest
import torch
from conftest import tiny

from portbench import refcore, yardstick


def test_na_bound_counts_by_hand():
    # 3 destinations; 5 valid slots from sources {10, 11, 12}; 4 kept slots
    # from sources {10, 11}; H = 2 heads of dh = 4 over a table of N = 20
    src = torch.tensor([10, 11, 12, 10, 11])
    kept = torch.tensor([10, 11, 10, 11])
    ms, what, nbytes, nops = yardstick.na_bound(src, kept, 3, (20, 2, 4))
    want_bytes = 5 * 1 + 5 * 4 + (3 * 2 + 3 * 2) * 4 + (3 + 1) * 4 + 2 * 8 * 4 + 3 * 8 * 4
    want_ops = 5 * (2 + 1) + 4 * 2 * 6 + 2 * 4 * 8
    assert (nbytes, nops) == (want_bytes, want_ops)
    assert what == "bytes"
    assert ms == pytest.approx(want_bytes / 3.35e12 * 1e3)


def test_han_flops_by_hand():
    cell = tiny("han.imdb")
    graph = {"node_counts": {"p": 10, "a": 4}, "feat_dims": {"p": 6, "a": 3}, "num_classes": 3,
             "relations": [], "label_type": "p"}
    rec = refcore.Record(graph["node_counts"], 1e-6)
    rec.entries = [{"kept_slots": 30}, {"kept_slots": 20}]
    d, s = 64, 128
    want = 2 * 10 * 6 * d + 2 * (2 * 2 * 10 * d + 2 * 10 * d * s + 2 * 10 * s) + 2 * 50 * d + 2 * 10 * d * 3
    assert cell.ref.flops(graph, cell.cfg, cell.traffic, rec) == want


def test_frozen_fused_bound_agrees_with_its_parts():
    # the fused bound is K1's less the alpha and ids round trip, plus K2's reads
    msk = torch.tensor([[True, True, False]])
    nbr = torch.tensor([[4, 5, 0]], dtype=torch.int32)
    th_src = torch.zeros(8, 2)
    th_dst = torch.zeros(1, 2)
    alpha = torch.zeros(1, 2, 2)
    ids = torch.tensor([[4, 5]], dtype=torch.int32)
    k1 = yardstick.k1_bound(msk, nbr, None, th_src, None, th_dst, alpha, ids)[0]
    assert k1[2] == 3 + 2 * 4 + (2 * 2 + 2) * 4 + (4 + 2) * 4
    fused = yardstick.fused_bound(k1, alpha, ids, torch.zeros(8, 2, 3), torch.zeros(1, 2, 3))
    assert fused[2] == k1[2] - 6 * 4 + 2 * 6 * 4 + 6 * 4
    assert fused[3] == k1[3] + (2 * 2 - 4) * 6 + 2 * 2 * 6
    assert np.isfinite(fused[0])
