"""``cert_call_ms``: one call of the joint certificate
(``swarm.apply_certificate``: ``sim/certificates.py`` on
``solvers/sparse_admm.py``) at the cell's shapes, on the positions and
velocities the window ended at. The call is captured alone as a CUDA
graph and replayed between CUDA events: the certificate layer timed from
outside the step."""

REPLAYS = 20


def read(trace):
    ctx = trace.context
    if not ctx.get("certificate") or ctx["x"].device.type != "cuda":
        return None
    import torch

    swarm, cfg, x, u = ctx["swarm"], ctx["cfg"], ctx["x"], ctx["v"]
    for _ in range(2):
        swarm.apply_certificate(cfg, u, x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        swarm.apply_certificate(cfg, u, x)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPLAYS
