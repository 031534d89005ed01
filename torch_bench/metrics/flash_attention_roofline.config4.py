"""The prefill attention kernel (#4, ``flash_attention_kernel``)
against its bound: each launch in the traced slice is matched, by its
host launch time, to the admission chunks being enqueued (one, or the
rows of one batched pass), and is held to one layer's share of their
bytes and causal operations (from each one's offset and real length) at
the card's peaks; summed over the launches, over their device time.  A
launch that falls in no taped chunk fails the run: its work would go
uncounted."""

from torch_bench import readers


def read(run):
    trace = run.get("trace")
    if trace is None:
        return None
    sizes, family = run["sizes"], run["family"]
    launched = trace.launch_time()
    chunks = run["tape"].chunks
    bound = spent = 0.0
    unmatched = 0
    for op in readers.kernel_share(trace, readers.PREFILL_KERNELS):
        at = launched.get(op[3])
        rows = [c for c in chunks if at is not None and c[0] <= at <= c[1]]
        if not rows:
            unmatched += 1
            continue
        for chunk in rows:
            n_bytes, flops = family.prefill_attention_work(sizes, chunk[2],
                                                           chunk[3])
            bound += readers.bound_s(n_bytes, flops) / sizes.layers
        spent += op[2] / 1e6
    if unmatched:
        raise RuntimeError(f"flash_attention_roofline: {unmatched} launch(es) "
                           f"in the slice fall in no taped admission chunk")
    return 100.0 * bound / spent if spent > 0 else None
