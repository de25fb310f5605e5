"""Microseconds a ``flash_attention`` call's ``flash_op.launch`` step spends
inside the CUDA runtime calls that launch its kernels (``cudaLaunch*``,
``cuLaunch*``), averaged over the traced calls. It lies inside
``flash_launch_us.attn``. It holds the launch calls' own cost, the
profiler's callback cost on each of them and any wait for room in the
launch queue, and does not tell these apart."""

from port_bench.program_spans import launch_calls_us


def read(run):
    return launch_calls_us(run, "flash_op.launch")
