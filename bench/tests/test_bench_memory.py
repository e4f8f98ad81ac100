"""The window's memory reading counts what the process holds, so a
graphed round's buffers, kept in the graph's private pool and never
allocated by a replay, show in it."""
import pytest
import torch

from bench.harness import fl

MB = 10 ** 6


class GraphedAllocator:
    """The caching allocator's counts around a captured CUDA graph: the
    graph's pool stays reserved, a replay allocates nothing."""

    def __init__(self, live: int, pool: int, cached: int):
        self.live, self.pool, self.cached = live, pool, cached
        self.alloc_peak, self.res_peak = live, self.reserved()

    def reserved(self) -> int:
        return self.live + self.pool + self.cached

    def empty_cache(self):
        self.cached = 0

    def reset(self, dev=None):
        self.alloc_peak, self.res_peak = self.live, self.reserved()

    def install(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
        monkeypatch.setattr(torch.cuda, "empty_cache", self.empty_cache)
        monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", self.reset)
        monkeypatch.setattr(torch.cuda, "max_memory_reserved",
                            lambda dev=None: self.res_peak)
        monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                            lambda dev=None: self.alloc_peak)


@pytest.mark.parametrize("pool_mb", [0, 816, 1632])
def test_graph_pool_counts_in_the_window_peak(monkeypatch, pool_mb):
    # mlp3-xdevice's U and G are 816 MB each and live in the graph's pool
    a = GraphedAllocator(live=50 * MB, pool=pool_mb * MB, cached=7 * MB)
    a.install(monkeypatch)
    dev = torch.device("cuda", 0)
    fl.reset_memory_peak(dev)
    # a replay writes into the pool and allocates nothing
    assert fl.memory_peak(dev) == 50 * MB + pool_mb * MB
    assert torch.cuda.max_memory_allocated(dev) == 50 * MB


def test_off_the_card_reads_nothing():
    dev = torch.device("cpu")
    fl.reset_memory_peak(dev)
    assert fl.memory_peak(dev) == 0


@pytest.mark.card
def test_graph_pool_shows_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    x = torch.ones(1024, device=dev)
    n = 64 * 2 ** 20 // 4           # a 64 MiB float32 temporary a replay

    def body():
        return (x.repeat(n // 1024) * 2.0).sum()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    fl.reset_memory_peak(dev)
    live = torch.cuda.memory_allocated(dev)
    graph.replay()
    peak = fl.memory_peak(dev)
    assert float(out) == 2.0 * n
    assert torch.cuda.max_memory_allocated(dev) - live < n * 4
    assert peak - live >= n * 4
