"""bench.py's device table and its refusal to time anything but a GPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def test_h100_peaks_from_the_data_sheet():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"bfloat16": 989e12, "float32": 495e12, "bytes_per_s": 3.35e12}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "Tesla V100-SXM2-16GB"])
def test_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks(kind)


@pytest.mark.parametrize("argv", [[], ["--quick"]])
def test_main_refuses_a_cpu_backend(argv):
    assert bench.main(argv) == 2
