"""The reduction of a profiler trace to busy and idle time, the traced
window and the breakdown, on a trace written by hand (microseconds)."""
import pytest

from bench.harness import readings
from bench.harness.trace import Trace


def X(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    X("cudaLaunchKernel", "cuda_runtime", 100, 5),
    X("void chunk_reduce_pairs_kernel<float>", "kernel", 110, 20),
    X("void at::native::direct_copy_kernel_cuda", "kernel", 120, 20),
    X("cudaMemcpyAsync", "cuda_runtime", 150, 10),
    X("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 200, 10),
    X("void chunk_reduce_kernel<bf16>", "kernel", 250, 30),
    X("cudaDeviceSynchronize", "cuda_runtime", 255, 45),
    {"ph": "s", "name": "flow", "cat": "ac2g", "ts": 1},
]


def test_window_busy_and_gaps():
    tr = Trace(EVENTS)
    assert tr.window_s == pytest.approx(200e-6)
    # busy: [110, 140) [200, 210) [250, 280)
    assert tr.busy_s() == pytest.approx(70e-6)
    assert tr.idle_gaps() == [(100, 110), (140, 200), (210, 250), (280, 300)]


def test_breakdown_names_what_the_host_did():
    bd = Trace(EVENTS).breakdown()
    assert bd["device_ops"][0] == ["void chunk_reduce_kernel<bf16>",
                                   pytest.approx(30e-6)]
    gaps = dict((k, v) for k, v in bd["idle_gaps"])
    # (100, 110): the launch was over by 105; the host then prepared the
    # kernel that ended the gap
    assert gaps["host, before void chunk_reduce_pairs_kernel<float>"] == \
        pytest.approx(10e-6)
    # (140, 200): midpoint 170 is past the copy's call (150-160)
    assert gaps["host, before Memcpy DtoD (Device -> Device)"] == \
        pytest.approx(60e-6)
    # (280, 300): the host in the final synchronize
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(20e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_readers_of_the_trace():
    run = {"trace": Trace(EVENTS), "traced_units": 2,
           "least_bytes": 3.35e12 * 25e-6}
    assert readings.idle_share(run) == pytest.approx(65.0)
    # 2 x 25 us least over the 50 us of chunk_reduce kernels
    assert readings.roofline(run, "chunk_reduce") == pytest.approx(100.0)
    # the copy kernel and the device-to-device copy, per unit
    assert readings.copy_ms(run) == pytest.approx(1e3 * 30e-6 / 2)
    assert readings.idle_share({"trace": Trace([])}) is None
