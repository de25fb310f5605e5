"""Published peaks of the cards, the denominators of every roofline share.

NVIDIA's H100 data sheet, dense rates without sparsity, at the full power
limit (700 W for the SXM part): a card set below it reads lower shares, so
each run's line names the card. NVLink: 18 links of 25 GB/s a direction on
the SXM part, 450 GB/s that a card can send. Rows are matched by a
substring of the lower-cased ``torch.cuda.get_device_name()``, the most
specific first; a card that matches no row gets no roofline, never one
against a guessed peak.
"""

from __future__ import annotations

# (substring, bf16 dense FLOP/s, HBM bytes/s, NVLink bytes/s sent a card)
CARDS = (
    ("h100 pcie", 756e12, 2.0e12, None),
    ("h100 nvl", 835e12, 3.9e12, 300e9),
    ("h100", 989e12, 3.35e12, 450e9),
)


def card(kind: str) -> dict | None:
    """The peaks of the card named ``kind``, or None for a card not in
    the table."""
    lowered = kind.lower()
    for name, bf16, hbm, nvlink in CARDS:
        if name in lowered:
            return {"bf16_flops": bf16, "hbm_bytes": hbm,
                    "nvlink_bytes": nvlink}
    return None
