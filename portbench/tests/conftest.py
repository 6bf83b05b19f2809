"""The benchmark's own tests: they run on the CPU (the port's plain paths at tiny
sizes); those marked ``cuda`` need a card and skip without one."""
import os
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# The cells shrunk for a CPU run: a few rays and samples a slot, short phases.
SMALL = {"traffic": {"points_per_slot": 512, "sky_pad": 16},
         "config": {"optimizer": {"n_lidar_samples": 16, "n_samples_per_ray": 32},
                    "phase": {"num_iterations": 4}}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    """Skips the test where no CUDA card is present (decided when it runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
