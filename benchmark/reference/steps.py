"""A loop over time for the reference's recurrences: each step's plain
operations, launched one by one, or on the card replayed as a CUDA graph
of ``block`` steps over static buffers, so that a long read's loop costs
the card's time rather than the host's launches.  The arithmetic is the
same either way."""
import torch


def run_steps(step, ins, outs, block=64):
    """``step(*(a[t] for a in ins), *(o[t] for o in outs))`` for every t
    in order; ``step`` updates its own state in place and writes its
    outputs into the slices it is given."""
    T = ins[0].shape[0]
    dev = ins[0].device
    if dev.type != "cuda" or T < 3 * block:
        for t in range(T):
            step(*(a[t] for a in ins), *(o[t] for o in outs))
        return
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        # the first block runs plainly: it also warms up what the capture
        # must not create
        for t in range(block):
            step(*(a[t] for a in ins), *(o[t] for o in outs))
        s_in = [torch.empty((block,) + tuple(a.shape[1:]), dtype=a.dtype,
                            device=dev) for a in ins]
        s_out = [torch.empty((block,) + tuple(o.shape[1:]), dtype=o.dtype,
                             device=dev) for o in outs]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for u in range(block):
            step(*(a[u] for a in s_in), *(o[u] for o in s_out))
    torch.cuda.current_stream(dev).wait_stream(side)
    end = block + (T - block) // block * block
    for t0 in range(block, end, block):
        for s, a in zip(s_in, ins):
            s.copy_(a[t0:t0 + block])
        graph.replay()
        for s, o in zip(s_out, outs):
            o[t0:t0 + block].copy_(s)
    for t in range(end, T):
        step(*(a[t] for a in ins), *(o[t] for o in outs))
    del graph
