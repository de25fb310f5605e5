"""Device-plugin binary: ``python -m tpu_operator_torch.cli.device_plugin``
(installed as ``gpu-device-plugin`` in the operand image).

The port of ``tpu_operator/cli/device_plugin.py``; reference analogue:
NVIDIA k8s-device-plugin — advertises cards to kubelet over the
device-plugin gRPC API. ``--driver-lib-path`` takes the place of
``--libtpu-path``; the reference's ``--host-chips`` and
``--accelerator-type`` serve only the ICI bounds and have no counterpart.
The operator's DaemonSet configures it by environment: ``GPU_RESOURCE_NAME``,
``DEVICE_PLUGIN_DIR``, ``GPU_HEALTH_FILE`` and ``SLICE_AWARE``.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    from tpu_operator_torch.deviceplugin.discovery import (HEALTH_FILE_ENV,
                                                           GpuDiscovery)

    p = argparse.ArgumentParser(prog="gpu-device-plugin")
    p.add_argument("--resource-name",
                   default=os.environ.get("GPU_RESOURCE_NAME")
                   or "nvidia.com/gpu")
    p.add_argument("--plugin-dir",
                   default=os.environ.get("DEVICE_PLUGIN_DIR")
                   or "/var/lib/kubelet/device-plugins")
    p.add_argument("--dev-root", default="/dev")
    p.add_argument("--device-glob", default=None,
                   help="default: GPU_DEVICE_GLOB env, else nvidia[0-9]*")
    p.add_argument("--health-file",
                   default=os.environ.get(HEALTH_FILE_ENV) or None,
                   help="file listing unhealthy GPU indices, one per line "
                        "(written by the health monitor; default: "
                        f"{HEALTH_FILE_ENV} env)")
    p.add_argument("--strategy", choices=("device", "cdi"), default="device")
    p.add_argument("--driver-lib-path", default=None,
                   help="host libcuda.so.1 to mount read-only into "
                        "allocated containers")
    p.add_argument("--poll-seconds", type=float, default=5.0)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--log-format", choices=("text", "json"),
                   default="text")
    args = p.parse_args(argv)

    from tpu_operator_torch.deviceplugin.plugin import GpuDevicePlugin
    from tpu_operator_torch.utils.logs import setup_logging
    setup_logging(args.verbose, args.log_format)

    discovery = GpuDiscovery(args.dev_root, args.device_glob,
                             args.health_file)
    if os.environ.get("SLICE_AWARE", "").lower() == "true":
        # re-advertise per NVLink group when the slice manager has written
        # a plan (the MIG-strategy analogue)
        from tpu_operator_torch.deviceplugin.discovery import \
            SliceAwareDiscovery
        discovery = SliceAwareDiscovery(discovery)

    plugin = GpuDevicePlugin(
        resource_name=args.resource_name,
        plugin_dir=args.plugin_dir,
        discovery=discovery,
        strategy=args.strategy,
        driver_lib_host_path=args.driver_lib_path,
        poll_seconds=args.poll_seconds)
    try:
        plugin.run_forever()
    except KeyboardInterrupt:
        plugin.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
