"""backward_device_ms (ms, device trace): device time a step of the
work launched while the benchmark's span around torch.autograd.grad is
open."""


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0:
        return None
    return 1e3 * t.span_device_s.get("h100_bench.backward", 0.0) / t.items
