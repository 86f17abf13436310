"""Roofline annotation: peaks come from one table keyed by device_kind, an
unknown device is an error, a CPU record carries no roofline fields, and
no record may publish a physically impossible utilization."""

import types

import pytest

from benchmarks import roofline

H100 = types.SimpleNamespace(platform="gpu",
                             device_kind="NVIDIA H100 80GB HBM3")
PEAKS = roofline.PEAKS[H100.device_kind]


def test_annotate_basic_fields():
    rec = roofline.annotate({}, flops_per_step=1e9, bytes_per_step=1e9,
                            steps_per_s=10.0, device=H100)
    assert rec["achieved_tflops"] == 0.01
    assert 0 < rec["mfu"] < 1 and 0 < rec["hbm_util"] < 1
    assert rec["bound"] == "overhead"
    assert rec["peak_tflops_assumed"] == 67.0
    assert rec["peak_hbm_gbs_assumed"] == 3350.0
    assert "bound_model" not in rec


@pytest.mark.parametrize("precision,peak", [("bfloat16", 989.0),
                                            ("tf32", 495.0),
                                            ("float32", 67.0)])
def test_h100_peaks_by_precision(precision, peak):
    rec = roofline.annotate({}, 1e12, 1.0, steps_per_s=1.0, device=H100,
                            precision=precision)
    assert rec["peak_tflops_assumed"] == peak
    assert rec["mfu"] == round(1.0 / peak, 5)


def test_unknown_device_raises():
    other = types.SimpleNamespace(platform="gpu", device_kind="Some GPU")
    with pytest.raises(KeyError, match="Some GPU"):
        roofline.annotate({}, 1e9, 1e6, steps_per_s=1.0, device=other)


def test_cpu_record_has_no_roofline_fields():
    cpu = types.SimpleNamespace(platform="cpu", device_kind="cpu")
    rec = roofline.annotate({"model": "x"}, 1e9, 1e6, steps_per_s=1.0,
                            device=cpu)
    assert rec == {"model": "x"}


def test_annotate_clamps_impossible_hbm_util():
    """Any >1 utilization must be clamped to 1.0, kept raw, and
    flagged."""
    # bytes/step chosen so raw hbm_util ~ 1.33 at the given rate
    bytes_per_step = 1.33 * PEAKS["hbm_gbs"] * 1e9
    rec = roofline.annotate({}, flops_per_step=1e12,
                            bytes_per_step=bytes_per_step,
                            steps_per_s=1.0, device=H100)
    assert rec["hbm_util"] == 1.0
    assert abs(rec["hbm_util_raw"] - 1.33) < 0.01
    assert rec["bound_model"] == "exceeded-by-fusion"
    assert rec["bound"] == "bandwidth"


def test_annotate_clamps_impossible_mfu():
    rec = roofline.annotate({}, flops_per_step=2 * PEAKS["float32"] * 1e12,
                            bytes_per_step=1.0, steps_per_s=1.0,
                            device=H100)
    assert rec["mfu"] == 1.0 and rec["mfu_raw"] > 1.9
    assert rec["bound_model"] == "exceeded-by-fusion"


def test_annotate_bound_override():
    rec = roofline.annotate({}, 1e6, 1e3, steps_per_s=1.9e6, device=H100,
                            bound_override="serial-latency")
    assert rec["bound"] == "serial-latency"
    assert rec["mfu"] is not None and rec["mfu"] < 1


def test_dense_mf_byte_model_is_physical():
    """The perfect-fusion floor model keeps hbm_util below 1 at a rate
    whose bytes stay under the H100's bandwidth."""
    f, b = roofline.matrix_fact_dense(3000, 1500, 16)
    rate = 0.9 * PEAKS["hbm_gbs"] * 1e9 / b
    rec = roofline.annotate({}, f, b, steps_per_s=rate, device=H100,
                            precision="tf32")
    assert rec["hbm_util"] < 1.0 and "bound_model" not in rec


def test_peaks_for_names_the_table():
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3") is PEAKS
    with pytest.raises(KeyError, match="PEAKS"):
        roofline.peaks_for("Unlisted accelerator")
