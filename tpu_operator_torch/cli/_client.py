"""Shared --client resolution for operand CLIs.

A copy of ``tpu_operator/cli/_client.py`` on the port's ``kube/``.

``incluster`` is production; ``fake:/state.json`` joins the file-backed fake
cluster the e2e harness runs (same contract as the operator/kubectl CLIs),
so every operand binary can be driven hermetically; an ``https://`` URL
targets an explicit apiserver (the in-repo wire-protocol one, a
port-forward) with KUBE_TOKEN / KUBE_CA_FILE from the environment.
"""

from __future__ import annotations

import os


def url_client(spec: str):
    """Explicit apiserver URL; token/CA via env — secrets don't belong in
    argv (visible in `ps`)."""
    from tpu_operator_torch.kube.incluster import InClusterClient
    token = os.environ.get("KUBE_TOKEN")
    if not token:
        raise SystemExit(f"--client {spec}: set KUBE_TOKEN (and "
                         f"KUBE_CA_FILE for a self-signed server)")
    return InClusterClient(host=spec, token=token,
                           ca_file=os.environ.get("KUBE_CA_FILE"))


def build_operand_client(spec: str):
    if spec == "incluster":
        from tpu_operator_torch.kube.incluster import InClusterClient
        return InClusterClient()
    if spec.startswith(("https://", "http://")):
        return url_client(spec)
    if spec.startswith("fake:") and len(spec) > len("fake:"):
        from tpu_operator_torch.kube.fake import FileBackedFakeClient
        return FileBackedFakeClient(spec[len("fake:"):])
    raise SystemExit(
        f"unknown --client {spec!r} (use 'incluster', 'https://host:port' "
        f"or 'fake:/state.json')")
