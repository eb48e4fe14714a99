"""The median count, over the window's proves, of the copies from the card
to the host that start inside a prove's ``fri`` phase (protocols/fri.py):
the device trace's memcpy operations whose name begins ``Memcpy DtoH``
(for example ``Memcpy DtoH (Device -> Pageable)``).  None untraced."""

from portbench import parts

COPY_OUT = "Memcpy DtoH"


def read(win):
    return parts.ops_per_prove(win, "fri", COPY_OUT)
