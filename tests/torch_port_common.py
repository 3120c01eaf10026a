"""Shared pieces of the PyTorch-port tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages;
the JAX side runs on the CPU (Pallas kernels in interpret mode).
Tests that need a CUDA card take the :func:`cuda_device` fixture and
carry the ``cuda`` marker: they skip, with a reason, where there is no
card.  Whether there is a card is decided inside the fixture, never
at import time, so every pytest worker collects the same tests.
"""

import os

import numpy as np
import pytest
import torch

#: the JAX package's BOX output on examples/10017, one directory per
#: setting (``tests/golden/make_torch_port_golden.py`` writes them)
GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "golden", "torch_port_10017"
)
#: golden setting -> (solver, use_pallas)
SETTINGS = {
    "lp_device": ("lp_device", False),
    "lp_device_pallas": ("lp_device", True),
    "lp_device_fused": ("lp_device_fused", False),
    "greedy": ("greedy", False),
}

# pytest workers run side by side: keep each one's intra-op pool small
torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs a CUDA GPU: the port's kernels have no CPU mode "
            "(run these on the card, see README 'PyTorch port')"
        )
    return torch.device("cuda")


def t(a, device="cpu"):
    """numpy -> torch on ``device`` (bool and integer dtypes kept)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def n(x):
    """torch/JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def neighbor_inputs(n_a: int, m_b: int, seed=None):
    """The reference neighbour kernel's contract-probe inputs."""
    rng = np.random.default_rng(n_a + m_b if seed is None else seed)
    xa = rng.uniform(0, 2000.0, (n_a, 2)).astype(np.float32)
    xb = rng.uniform(0, 2000.0, (m_b, 2)).astype(np.float32)
    ma = rng.uniform(size=n_a) > 0.15
    mb = rng.uniform(size=m_b) > 0.15
    return xa, ma, xb, mb


def clique_inputs(k: int, n_p: int, seed=None):
    """The reference clique kernel's contract-probe inputs: clustered
    fields, so real cliques and zero-weight ties form."""
    rng = np.random.default_rng(1000 * k + n_p if seed is None else seed)
    base = rng.uniform(0, 1500.0, (n_p, 2))
    xy = (base[None] + rng.normal(0, 25.0, (k, n_p, 2))).astype(np.float32)
    conf = rng.uniform(0.5, 1.0, (k, n_p)).astype(np.float32)
    mask = rng.uniform(size=(k, n_p)) > 0.15
    return xy, conf, mask


def solve_inputs(c: int, k: int, v: int = 64, seed=None):
    """The reference solve kernel's contract-probe inputs."""
    rng = np.random.default_rng(7 * c + k if seed is None else seed)
    mv = rng.integers(0, v, (c, k)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (c,)).astype(np.float32)
    valid = rng.uniform(size=c) > 0.2
    return mv, w, valid
