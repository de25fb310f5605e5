"""The GPU node agents, in C++: ``gpu-smoke``, ``gpu-node-agent``,
``gpu-metrics-agent`` and ``gpu-oci-hook``, with the test-only driver
stand-in ``libfake-cuda.so``. ``build`` compiles them with the host C++
compiler at first use; importing this package builds nothing."""
