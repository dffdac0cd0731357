"""The port's timing metrics (``gravity_tpu_torch/utils/timing.py``) against
the JAX package's ``gravity_tpu/utils/timing.py``, on the CPU.

Counts, labels, formulations and throughput agree exactly on the same
inputs; the roofline agrees exactly wherever neither package quotes a
peak (``device_kind`` None or the CPU) and in every field but the peak
elsewhere: the JAX package quotes its TPUs' peaks, the port the H100's
(NVIDIA's H100 SXM5 datasheet: bf16 989.4, TF32 494.7 TFLOP/s, dense).
"""

import time

import pytest
import torch

from gravity_tpu.utils import timing as jt
from gravity_tpu_torch.utils import timing as tt

BACKENDS = ["dense", "chunked", "pallas", "pallas-mxu", "cpp", "nlist",
            "tree", "fmm", "sfmm", "pm", "p3m", "auto", "unknown"]
H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("backend", BACKENDS)
def test_labels_and_formulations_match_jax(backend):
    assert tt.pairs_metric_name(backend) == jt.pairs_metric_name(backend)
    assert tt.backend_formulation(backend) == jt.backend_formulation(backend)


def test_the_ports_kernel_names_label_as_their_jax_names():
    """The resolved names of the two CUDA direct sums take the labels and
    formulations of the JAX names they stand for."""
    for port, jax_name in (("nbody_direct", "pallas"),
                           ("nbody_mxu", "pallas-mxu")):
        assert tt.pairs_metric_name(port) == jt.pairs_metric_name(jax_name)
        assert tt.backend_formulation(port) == jt.backend_formulation(
            jax_name)
    assert set(jt.DIRECT_SUM_BACKENDS) <= set(tt.DIRECT_SUM_BACKENDS)
    assert tt.FLOPS_PER_PAIR == jt.FLOPS_PER_PAIR


@pytest.mark.parametrize("n", [1, 2, 1000, 262_144, 2_097_152])
def test_pairs_per_step_matches_jax(n):
    assert tt.pairs_per_step(n) == jt.pairs_per_step(n) == n * (n - 1)


@pytest.mark.parametrize("n,steps,seconds,devices,evals", [
    (512, 20, 0.125, 1, 1), (262_144, 20, 0.75, 1, 1),
    (1000, 7, 3.5, 4, 3), (64, 0, 1.0, 1, 1), (64, 5, 0.0, 1, 1)])
def test_throughput_matches_jax(n, steps, seconds, devices, evals):
    kw = dict(num_devices=devices, force_evals_per_step=evals)
    assert tt.throughput(n, steps, seconds, **kw) == jt.throughput(
        n, steps, seconds, **kw)


@pytest.mark.parametrize("formulation", ["vpu", "mxu", "jnp", "nlist",
                                         "other"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_roofline_matches_jax_where_no_peak_is_quoted(formulation, dtype):
    """No device kind, or the CPU: both give the same dict, mfu None."""
    for kind in (None, "cpu"):
        port = tt.roofline(1.79e12, formulation=formulation,
                           device_kind=kind, dtype=dtype)
        ref = jt.roofline(1.79e12, formulation=formulation,
                          device_kind=kind, dtype=dtype)
        assert port == ref
        assert port["mfu"] is None and port["peak_tflops"] is None


def test_roofline_quotes_the_h100_and_no_tpu():
    """The port's peak table holds the H100 alone: a TPU's name quotes no
    peak in the port, while the achieved rate agrees with the JAX
    package's for every kind."""
    for kind in ("TPU v5 lite", "TPU v4", "TPU v6e"):
        port = tt.roofline(1.6e11, device_kind=kind)
        ref = jt.roofline(1.6e11, device_kind=kind)
        assert ref["peak_tflops"] is not None
        assert port["peak_tflops"] is None and port["mfu"] is None
        for key in ("flops_per_pair", "achieved_tflops", "device_kind",
                    "formulation"):
            assert port[key] == ref[key]
    assert tt.device_peak_tflops(H100, "bfloat16") == 989.4
    assert tt.device_peak_tflops(H100, "float32") == 494.7
    assert tt.device_peak_tflops(H100, "float64") == 494.7
    assert tt.device_peak_tflops("NVIDIA A100-SXM4-80GB") is None
    r = tt.roofline(1.79e12, formulation="vpu", device_kind=H100)
    assert r["achieved_tflops"] == pytest.approx(35.8)
    assert r["mfu"] == pytest.approx(35.8 / 494.7)


def test_step_timer_and_fences():
    timer = tt.StepTimer()
    timer.start()
    time.sleep(0.01)
    assert timer.mark() >= 0.01
    assert timer.total >= 0.01 and timer.avg_step(2) == timer.total / 2
    # the CPU's fences return at once
    tt.sync(torch.device("cpu"))
    tt.warm_sync("cpu")
    tt.sync(None)
