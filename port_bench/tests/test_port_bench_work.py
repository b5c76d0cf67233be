"""The operation and byte counts the roofline divides, against shapes
worked by hand."""

import pytest
import torch

from port_bench.work import knn as work
from port_bench.work.peaks import PEAKS


def test_search_work_by_hand():
    # One swarm of 4096 agents, k=8, 100,000 in-radius candidates:
    # 8 * 4096 * 4095 pair operations + 8 per candidate; positions 4096 x
    # 2 x 4 B in, indices and distances 4096 x 8 x 8 B and nearest and
    # counts 4096 x 8 B out.
    ops, nbytes = work.search_work(1, 4096, 8, 100_000)
    assert ops == 8 * 4096 * 4095 + 800_000 == 134_984_960
    assert nbytes == 32_768 + 262_144 + 32_768 == 327_680
    # The member axis multiplies both; a radius array adds 4 B a member.
    ops, nbytes = work.search_work(1024, 64, 8, 7 * 65536,
                                   radius_array=True)
    assert ops == 8 * 1024 * 64 * 63 + 8 * 7 * 65536
    assert nbytes == 1024 * 64 * 8 + 4096 + 1024 * 64 * 64 + 1024 * 64 * 8


def test_bound_takes_the_larger_side():
    ops, nbytes = work.search_work(1, 4096, 8, 100_000)
    assert work.bound_s(ops, nbytes) == pytest.approx(ops / 67e12)
    ops, nbytes = work.search_work(1024, 64, 8, 0)
    assert work.bound_s(ops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert PEAKS["fp32_flops"] == 67e12
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12


def test_candidates_counts_ordered_in_radius_pairs():
    x = torch.tensor([[0.0, 0.0], [0.3, 0.0], [0.0, 0.5], [0.0, 0.0]])
    # In radius 0.4: (0,1), (1,3) and their reverses; the coincident pair
    # (0,3) is no candidate, (0,2) and (2,3) are beyond the radius.
    assert work.candidates(x, 0.4) == 4
    assert work.candidates(torch.stack([x, x]), 0.4) == 8
