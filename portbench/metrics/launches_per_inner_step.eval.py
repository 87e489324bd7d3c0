"""Device kernels launched in the profiled slice over its inner steps
(59 task-axis steps): the host dispatch's count of work."""
from portbench.readers import launches_per_inner_step


def read(trace):
    return launches_per_inner_step(trace)
