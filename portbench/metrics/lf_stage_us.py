"""lf_stage_us: device time of the per-stage LF step's kernel a call."""

LAYER = "per-stage LF step (ops/lf.lf_stage)"
UNIT = "us"
MOVES = "build_mbases_per_s"
READS = "lf_stage_kernel's device time and lf_stage.launches"
PATTERNS = ("lf_stage_kernel",)
COUNTERS = {"lf_stage": "rust_msbwt_tpu_torch.ops.lf:lf_stage"}


def read(trace):
    calls = trace.counters.get("lf_stage", 0)
    seconds = trace.device_seconds(PATTERNS)
    return seconds / calls * 1e6 if calls and seconds else None
