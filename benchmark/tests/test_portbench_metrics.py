"""The readers' arithmetic on made-up records and traces: roofline and MFU
shares, busy and idle from a timeline, and silence where the window over
replays lacks kernel nodes or the launches differ from the sites counted."""

import types

import pytest

from benchmark.harness import spec
from benchmark.harness.main import Record
from benchmark.harness.roofline import AttentionSite, bound_s
from benchmark.harness.trace import Spans, Trace, read_events
from benchmark.tests import tiny

READERS = spec.readers([{"name": n} for n in (
    "flash_roofline_pct", "mfu_pct", "elementwise_ms", "device_idle_pct", "denoise_ms", "decode_ms",
    "image_ms", "image_ms_p90", "peak_mem_gib", "setup_s", "first_request_s", "capture_s")])
FLASH = "void fa_wgmma_kernel<__nv_bfloat16, 64>(Params)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<c10::BFloat16> >(int)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
SITES = [AttentionSite(b=2, h=8, m=4096, n=4096, d=40, calls=50), AttentionSite(b=1, h=1, m=4096, n=4096, d=512)]
FAMILY = types.SimpleNamespace(kernel1_sites=lambda cell: SITES,
                               flops_per_request=lambda cell, specs: {"flops": 18.6e12})


def _record(trace=None, k1=51.0, completed=100, window=(10.0, 37.0)):
    spans = Spans()
    for i in range(completed):
        a = window[0] + 0.27 * i
        spans.records["request"].append((a, a + 0.27))
        spans.records["decode"].append((a + 0.24, a + 0.27))
    spans.records["first_request"].append((1.0, 4.5))
    spans.records["capture"].append((4.5, 5.25))
    return Record(cell=None, setup_s=12.5, spans=spans, window=window,
                  latencies=[0.27] * (completed - 1) + [0.3], completed=completed, peak_bytes=5 * 2 ** 30,
                  trace=trace, family=FAMILY, kernel1_launches=k1, specs={})


def _trace(flash_count=102, complete=True):
    ops = {FLASH: (flash_count, 2 * 0.006), ELEMENTWISE: (5000, 2 * 0.05), GEMM: (4000, 2 * 0.15)}
    return Trace(requests=2, window_s=0.6, busy_s=0.51, ops=ops, idle_by_span={"encode": 0.05},
                 complete=complete, missing={} if complete else {"fa_wgmma_kernel": (90, 102)})


def test_flash_roofline_share():
    least = sum(s.calls * bound_s(s.ops, s.bytes) for s in SITES)
    got = READERS["flash_roofline_pct"].read(_record(_trace()))
    assert got == pytest.approx(100 * least / 0.006)
    assert 0 < got < 100


@pytest.mark.parametrize("case", ["lacks nodes", "fewer launches traced", "other launches counted", "no trace"])
def test_flash_roofline_silent(case):
    rec = {"lacks nodes": _record(_trace(complete=False)), "fewer launches traced": _record(_trace(flash_count=90)),
           "other launches counted": _record(_trace(), k1=41.0), "no trace": _record()}[case]
    assert READERS["flash_roofline_pct"].read(rec) is None


def test_mfu_share():
    rec = _record()
    assert READERS["mfu_pct"].read(rec) == pytest.approx(100 * 18.6e12 / (0.27 * 989e12))


def test_elementwise_and_idle():
    rec = _record(_trace())
    assert READERS["elementwise_ms"].read(rec) == pytest.approx(50.0)
    assert READERS["device_idle_pct"].read(rec) == pytest.approx(15.0)
    for name in ("elementwise_ms", "device_idle_pct"):
        assert READERS[name].read(_record(_trace(complete=False))) is None


def test_window_metrics():
    rec = _record()
    assert READERS["image_ms"].read(rec) == pytest.approx(270.0)
    assert READERS["image_ms_p90"].read(rec) == pytest.approx(270.0)
    rec.latencies[-15:] = [float("inf")] * 15  # 15 % failed: the 90th percentile is beyond every answer
    assert READERS["image_ms_p90"].read(rec) is None
    assert READERS["peak_mem_gib"].read(rec) == 5.0
    assert READERS["denoise_ms"].read(rec) == pytest.approx(240.0)
    assert READERS["decode_ms"].read(rec) == pytest.approx(30.0)
    assert READERS["first_request_s"].read(rec) == 3.5 and READERS["capture_s"].read(rec) == 0.75
    assert READERS["setup_s"].read(rec) == 12.5


class _Ev:
    def __init__(self, name, start, end, device):
        self.name, self.device_type = name, device
        self.time_range = types.SimpleNamespace(start=start, end=end)


def test_read_events_busy_idle_and_missing_nodes():
    cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"
    events = [_Ev("bench:request", 0, 1000, cpu), _Ev("bench:encode", 0, 100, cpu), _Ev("bench:step", 100, 900, cpu),
              _Ev("bench:decode", 900, 1000, cpu), _Ev("bench:step", 100, 900, cuda),
              _Ev(GEMM, 50, 400, cuda), _Ev(FLASH, 300, 500, cuda), _Ev(ELEMENTWISE, 600, 950, cuda),
              _Ev("Memcpy DtoH (Device -> Pinned)", 980, 990, cuda), _Ev(GEMM, 1200, 1300, cuda)]
    from onnxstream_tpu_torch.kernels import kernel_name as name

    t = read_events(events, {"fa_wgmma_kernel": 1}, name, requests=1)
    assert t.window_s == pytest.approx(1e-3) and t.busy_s == pytest.approx(((500 - 50) + (950 - 600) + 10) * 1e-6)
    assert t.idle_by_span == pytest.approx({"encode": 50e-6, "step": 100e-6, "decode": 40e-6})
    assert t.complete and t.ops[FLASH] == (1, pytest.approx(200e-6))
    t = read_events(events, {"fa_wgmma_kernel": 2}, name, requests=1)
    assert not t.complete and t.missing == {"fa_wgmma_kernel": (1, 2)}


def test_tiny_limits_are_data():
    assert set(tiny.LIMITS["limits"]) == {"latent_rel", "image_mae"}
