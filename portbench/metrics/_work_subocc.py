"""The work of one K1 call in its disp+pan+subocc mode, from its shapes
alone, as metrics/_work.py counts the other modes.  Not a metric (its name
starts with ``_``).

Operations per logit, those of the plain head's math (reference/med.py,
reference/mom.py), an exp or a division counting one: disparity 7 and pan
8 + 5C, as _work.med_fwd counts them, and each mask 4: the shifted lerp
(3) and the sum over planes (1); 38 at C = 3.
Bytes: the logits and the image read once; disp, pan, maskL and maskR
written once; fp32.
"""

from __future__ import annotations

from portbench.metrics._work import F32


def med_subocc(b: int, n: int, h: int, w: int, c: int = 3) -> tuple[int, int]:
    """(bytes, operations) of one K1 call returning disp, pan and both masks."""
    logits, pix = b * n * h * w, b * h * w
    nbytes = (logits + c * pix + pix + c * pix + 2 * pix) * F32
    return nbytes, logits * (7 + 8 + 5 * c + 2 * 4)
