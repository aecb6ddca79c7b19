"""Kernel nodes an update in the update phase's graph: the program's count
at capture (``border_tpu_torch.train.graphs.nodes``: the kernel nodes of
each graph's newest capture and the updates its body makes) of the newest
graph whose body makes updates, over those updates.  Every replay
launches each node; a profiler can lose some of a replay's kernel
records.  None from a program that keeps no such count."""


def read(ctx):
    from border_tpu_torch.train import graphs

    held = [(k, u) for k, u in getattr(graphs, "nodes", {}).values() if u]
    if not held:
        return None
    kernels, updates = held[-1]
    return kernels / updates
