"""The CUDA joint2 kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA card and skips without one. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import xhistogram_torch
from xhistogram_torch import bins as tbins
from xhistogram_torch.ops import cuda_hist
from ts_cases import (
    EDGE_SETS, S_EDGES, T_EDGES, edge_case_data, numpy_hist2d, ts_data,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _thresholds(edges, device):
    ce = tbins.compare_form(edges, np.float32)
    assert ce.n_hi_clip == 0
    return torch.from_numpy(ce.edges).to(device)


def _kernel_and_plain(t, s, te, se, device):
    """(kernel counts, plain counts) on the card for the same inputs."""
    ta, tb = _thresholds(te, device), _thresholds(se, device)
    nba, nbb = len(te) - 1, len(se) - 1
    before = cuda_hist.JOINT2_LAUNCHES
    got = cuda_hist.joint2(t, s, ta, tb, nba, nbb)
    torch.cuda.synchronize()
    assert cuda_hist.JOINT2_LAUNCHES == before + (1 if t.numel() else 0)
    want = cuda_hist.joint2_reference(t, s, ta, tb, nba, nbb)
    assert got.device == t.device and got.dtype == torch.int64
    return got.cpu(), want.cpu()


@pytest.mark.parametrize("name", list(EDGE_SETS))
def test_edge_cases(cuda, name):
    te, se = EDGE_SETS[name]
    t, s = edge_case_data(te, se, n_random=10_000)
    got, want = _kernel_and_plain(
        torch.from_numpy(t).to(cuda), torch.from_numpy(s).to(cuda), te, se, cuda
    )
    assert torch.equal(got, want)
    nba, nbb = len(te) - 1, len(se) - 1
    np.testing.assert_array_equal(
        got[0, :-1].reshape(nba, nbb).numpy(), numpy_hist2d(t, s, te, se)
    )


def test_negative_subnormal_is_below_a_zero_edge(cuda):
    te = np.array([0.0, 1.0])
    t = torch.tensor([-1e-45, 1e-45, -0.0, 0.0], device=cuda)
    s = torch.full((4,), 0.5, device=cuda)
    got, _ = _kernel_and_plain(t, s, te, te, cuda)
    assert got.tolist() == [[3, 0]]


@pytest.mark.parametrize("n", [0, 1, 7, 4097, (1 << 20) + 3, 1 << 24])
def test_ragged_sizes_and_views(cuda, n):
    t_np, s_np = ts_data((n,), seed=n)
    t, s = torch.from_numpy(t_np).to(cuda), torch.from_numpy(s_np).to(cuda)
    for view in (lambda x: x, lambda x: x.reshape(1, n)):
        got, want = _kernel_and_plain(view(t), view(s), T_EDGES, S_EDGES, cuda)
        assert torch.equal(got, want)
    if n:  # a strided view is copied first, with the same counts
        got, want = _kernel_and_plain(t[::2], s[::2], T_EDGES, S_EDGES, cuda)
        assert torch.equal(got, want)


def test_alternating_grid_sizes(cuda):
    # each grid needs its own shared-memory size; the launcher's cached
    # launch shape must follow every switch
    t_np, s_np = ts_data((1 << 16,), seed=5)
    t, s = torch.from_numpy(t_np).to(cuda), torch.from_numpy(s_np).to(cuda)
    small = (np.linspace(-2, 30, 9), np.linspace(30, 40, 10))
    for te, se in (small, (T_EDGES, S_EDGES), small, (T_EDGES, S_EDGES)):
        got, want = _kernel_and_plain(t, s, te, se, cuda)
        assert torch.equal(got, want)


def test_auto_on_a_strided_full_reduction(cuda):
    t_np, s_np = ts_data((64, 4096), seed=4)
    t, s = torch.from_numpy(t_np).to(cuda), torch.from_numpy(s_np).to(cuda)
    before = cuda_hist.JOINT2_LAUNCHES
    h, _ = xhistogram_torch.histogram(
        t[:, :1000], s[:, :1000], bins=[T_EDGES, S_EDGES]
    )
    assert cuda_hist.JOINT2_LAUNCHES == before + 1
    np.testing.assert_array_equal(
        h.cpu().numpy(),
        numpy_hist2d(t_np[:, :1000], s_np[:, :1000], T_EDGES, S_EDGES),
    )


def test_auto_runs_the_kernel_on_the_main_path(cuda):
    t_np, s_np = ts_data((64, 4096), seed=3)
    before = cuda_hist.JOINT2_LAUNCHES
    h, _ = xhistogram_torch.histogram(
        torch.from_numpy(t_np).to(cuda), torch.from_numpy(s_np).to(cuda),
        bins=[T_EDGES, S_EDGES],
    )
    assert cuda_hist.JOINT2_LAUNCHES == before + 1
    assert h.device.type == "cuda" and h.dtype == torch.int64
    np.testing.assert_array_equal(
        h.cpu().numpy(), numpy_hist2d(t_np, s_np, T_EDGES, S_EDGES)
    )


def test_auto_routing_outside_the_kernel(cuda):
    x = torch.linspace(0, 2, 1000, device=cuda)
    e = np.array([0.0, 1.0, 2.0])
    with pytest.raises(NotImplementedError, match="'one_input' kernel"):
        xhistogram_torch.histogram(x, bins=[e])
    with pytest.raises(NotImplementedError, match="float32 data only"):
        xhistogram_torch.histogram(x.double(), x.double(), bins=[e, e])
    # a +inf top edge: the JAX package's auto gate runs scatter, and so here
    before = cuda_hist.JOINT2_LAUNCHES
    h, _ = xhistogram_torch.histogram(x, x, bins=[np.array([0.0, np.inf]), e])
    assert cuda_hist.JOINT2_LAUNCHES == before
    assert h.device.type == "cuda" and h.cpu().tolist() == [[500, 500]]
