"""The one wording of the port's refusals of what is not ported yet."""
from typing import Optional


def not_ported(what: str, item: Optional[str] = None,
               verb: str = "is") -> str:
    """``"<what> is not ported to deepspeed_tpu_torch yet (ROADMAP.md
    queue C[, <item>])"``: the message of the ``NotImplementedError``
    raised where a caller asks for something still in ROADMAP.md's queue
    (``item`` names its entry, such as ``"A8"``)."""
    where = "queue C" if item is None else f"queue C, {item}"
    return (f"{what} {verb} not ported to deepspeed_tpu_torch yet "
            f"(ROADMAP.md {where})")
