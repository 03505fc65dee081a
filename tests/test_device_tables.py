"""What the code decides from the device it finds: the benchmark's peak
table, the BA engine default, the native library's build key."""

import platform

import pytest

import bench
from slam_tpu import runtime
from slam_tpu.ops import ba


def test_peak_table_holds_the_h100_data_sheet():
    p = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert p == {"bf16_flops": 989e12, "tf32_flops": 495e12,
                 "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


@pytest.mark.parametrize("kind", ["NVIDIA H200", "NVIDIA A100-SXM4-80GB",
                                  "cpu"])
def test_peak_table_refuses_unknown_device_kind(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks(kind)


def test_bench_refuses_to_measure_without_gpu():
    info = bench.device_info()
    assert info["platform"] == "cpu" and info["count"] >= 1
    with pytest.raises(SystemExit, match="measures the GPU"):
        bench.main()


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_default_engine_per_backend(backend):
    assert ba.default_engine(backend) == ba.DEFAULT_ENGINE[backend]
    assert ba.default_engine(backend) == "scatter"


def test_default_engine_refuses_unknown_backend():
    with pytest.raises(ValueError, match="no default BA engine"):
        ba.default_engine("rocm")
    assert ba.default_engine() == ba.DEFAULT_ENGINE["cpu"]


def test_native_library_is_keyed_to_source_and_host(monkeypatch):
    here = runtime._lib_path()
    assert here.parent == runtime._HERE
    assert here.name.startswith("libslamtpu_native-")
    monkeypatch.setattr(platform, "node", lambda: "another-host")
    assert runtime._lib_path() != here
