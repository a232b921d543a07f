"""lf_pair_us: device time of the radix-2 column pair's kernels a call."""

LAYER = "radix-2 column pair (ops/lf.lf_pair)"
UNIT = "us"
MOVES = "build_mbases_per_s"
READS = "the pair kernels' device time and lf_pair.launches"
PATTERNS = ("pair_first_kernel", "pair_rank1_kernel", "pair_rank2_kernel", "pair_final_kernel")
COUNTERS = {"lf_pair": "rust_msbwt_tpu_torch.ops.lf:lf_pair"}


def read(trace):
    calls = trace.counters.get("lf_pair", 0)
    seconds = trace.device_seconds(PATTERNS)
    return seconds / calls * 1e6 if calls and seconds else None
