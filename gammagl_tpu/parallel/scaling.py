"""Analytical compute/communication scaling model for partitioned
full-graph training (BASELINE target: >=75% edges/s efficiency from 1
device to N).

The halo-partitioned layer does, per device and per layer:
  compute: local SpMM over E_p edges (memory-bandwidth bound, not FLOP
           bound) + dense GEMMs
  comm:    one all_to_all of P*H boundary feature rows between the
           devices of a host and/or across hosts (hier tier)

The estimate is the serial sum of those two terms: the halo tiers run the
exchange before the aggregation that needs it.

Peak rates come from `PEAKS`, keyed by `jax.Device.device_kind`; a device
not in the table is an error, never a default.
"""

from typing import NamedTuple

__all__ = ["HwModel", "PEAKS", "hw_model", "halo_scaling_estimate"]


class HwModel(NamedTuple):
    """Published per-device peak rates."""
    hbm_gbps: float      # device memory bandwidth, GB/s
    link_gbps: float     # device-to-device link, GB/s each way
    bf16_tflops: float   # dense bf16 matrix peak, TFLOP/s


# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, NVLink 900 GB/s total
# (450 GB/s each way), 989 TFLOP/s dense bf16, at the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": HwModel(hbm_gbps=3350.0, link_gbps=450.0,
                                     bf16_tflops=989.0),
}


def hw_model(device_kind: str) -> HwModel:
    """Peak rates of `device_kind`; raises KeyError for a device with no
    published entry in `PEAKS`."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no peak rates for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def halo_scaling_estimate(num_parts, edges_per_part, halo_rows_sent,
                          feat_dim, spmm_edges_per_s, hw: HwModel,
                          itemsize=2, inter_host_rows_sent=0,
                          inter_host_gbps=None, total_edges=None):
    """Roofline estimate of halo-partitioned SpMM scaling efficiency.

    Args:
      num_parts: devices in the partition.
      edges_per_part: max edges owned by one device (padded count).
      halo_rows_sent: boundary rows one device sends to the devices of
        its host per layer (sum over peers; the all_to_all also receives
        ~the same).
      feat_dim: feature width of the exchanged/aggregated activations.
      spmm_edges_per_s: the single-device SpMM rate, measured on the
        device `hw` describes.
      hw: the device's `HwModel` (see `hw_model`).
      itemsize: bytes per element (2 = bf16).
      inter_host_rows_sent: rows crossing host boundaries (hier tier);
        needs `inter_host_gbps`, the network rate of the deployment.

    Returns dict with per-layer times (s) and the estimated efficiency
    vs a single device running the whole graph at the same edge rate
    (the BASELINE ">=75% edges/s 1->N" metric).
    """
    if inter_host_rows_sent and inter_host_gbps is None:
        raise ValueError("inter_host_rows_sent needs inter_host_gbps")
    t_compute = edges_per_part / spmm_edges_per_s
    link_bytes = halo_rows_sent * feat_dim * itemsize
    host_bytes = inter_host_rows_sent * feat_dim * itemsize
    t_link = link_bytes / (hw.link_gbps * 1e9)
    t_host = (host_bytes / (inter_host_gbps * 1e9)
              if inter_host_rows_sent else 0.0)
    t_layer = t_compute + t_link + t_host
    if total_edges is None:
        total_edges = edges_per_part * num_parts  # incl. padding
    # efficiency: useful edges/s of the N-device run vs N devices each
    # running at the single-device rate (padding edges are NOT useful
    # throughput, so pass true total_edges when known)
    eff = ((total_edges / t_layer) / (num_parts * spmm_edges_per_s)
           if t_layer > 0 else 1.0)
    return {
        "num_parts": int(num_parts),
        "t_compute_s": t_compute,
        "t_link_s": t_link,
        "t_inter_host_s": t_host,
        "t_layer_s": t_layer,
        "link_bytes": int(link_bytes),
        "inter_host_bytes": int(host_bytes),
        "efficiency": float(min(eff, 1.0)),
    }
