"""The decode attention kernel (#2, ``flash_verify_kernel`` at one
query, with its combine) against its bound: for each loop block of the
traced slice, the bytes and operations its decoded tokens needed (the
keys and values of each row's live positions, the query and the output,
every layer) at the card's peaks, over the kernels' device time in that
block; summed over the blocks.  A block whose decode kernels ran in the
slice but that matches no taped dispatch and tokens fails the run."""

from torch_bench import readers


def read(run):
    trace = run.get("trace")
    if trace is None:
        return None
    sizes, family = run["sizes"], run["family"]
    dispatches = run["tape"].dispatches
    launched = trace.launch_time()
    tokens = {}
    for _, retired, _, k, plen, _ in run["tape"].emits:
        if k >= 1:
            tokens.setdefault(retired - 1, []).append(plen + k)
    bound = spent = 0.0
    unmatched = 0
    for corr, (_, _, ops) in readers.block_spans(trace).items():
        time_s = sum(op[2] for op in ops
                     if any(n in op[0] for n in readers.DECODE_KERNELS)) / 1e6
        if time_s <= 0:
            continue
        at = launched.get(corr)
        block = None if at is None else next(
            (i for i, t in enumerate(dispatches) if t >= at), None)
        if block is None or block not in tokens:
            unmatched += 1
            continue
        n_bytes = flops = 0
        for live in tokens[block]:
            b, f = family.decode_attention_work(sizes, live)
            n_bytes, flops = n_bytes + b, flops + f
        bound += readers.bound_s(n_bytes, flops)
        spent += time_s
    if unmatched:
        raise RuntimeError(f"flash_decode_roofline: {unmatched} block(s) in "
                           f"the slice match no taped dispatch and tokens")
    return 100.0 * bound / spent if spent > 0 else None
