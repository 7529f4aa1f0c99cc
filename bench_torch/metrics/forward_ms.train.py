"""forward_ms.train: median host ms of the train step's span
``train.forward``: the forward, the loss and the L2 penalty; over the
first traced stretch (the device alone profiled).

It reads under the device-only profiler, which costs the host a hook on
every op and an activity record on every launch
(``tests/test_torch_tracing.py::test_train_phases_carry_the_device_only_profilers_cost``
counts both), so the phase reads longer than in the untraced window: set
it against the other three phases, not against the window's step."""
from harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "train", "train.forward")
