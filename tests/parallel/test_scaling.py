"""Peak-rate table and the halo scaling roofline."""

import pytest

from gammagl_tpu.parallel import PEAKS, halo_scaling_estimate, hw_model


def test_h100_peaks_from_data_sheet():
    hw = hw_model("NVIDIA H100 80GB HBM3")
    assert (hw.hbm_gbps, hw.link_gbps, hw.bf16_tflops) == (3350.0, 450.0,
                                                          989.0)
    assert set(PEAKS) == {"NVIDIA H100 80GB HBM3"}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100",
                                  ""])
def test_unknown_device_has_no_peak(kind):
    with pytest.raises(KeyError):
        hw_model(kind)


def test_halo_estimate_serial_sum():
    hw = hw_model("NVIDIA H100 80GB HBM3")
    est = halo_scaling_estimate(num_parts=4, edges_per_part=1_000_000,
                                halo_rows_sent=45_000, feat_dim=256,
                                spmm_edges_per_s=1e9, hw=hw)
    assert est["t_compute_s"] == pytest.approx(1e-3)
    assert est["t_link_s"] == pytest.approx(45_000 * 256 * 2 / 450e9)
    assert est["t_layer_s"] == pytest.approx(est["t_compute_s"]
                                             + est["t_link_s"])
    assert 0 < est["efficiency"] < 1


def test_inter_host_rows_need_a_network_rate():
    hw = hw_model("NVIDIA H100 80GB HBM3")
    kw = dict(num_parts=8, edges_per_part=10, halo_rows_sent=1, feat_dim=4,
              spmm_edges_per_s=1e6, hw=hw, inter_host_rows_sent=5)
    with pytest.raises(ValueError):
        halo_scaling_estimate(**kw)
    est = halo_scaling_estimate(inter_host_gbps=50.0, **kw)
    assert est["inter_host_bytes"] == 5 * 4 * 2
