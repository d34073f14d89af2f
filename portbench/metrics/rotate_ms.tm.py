"""rotate_ms.tm: device ms an orientation under the program's span
match.template (kernel A at the template's box, the wedge, the
normalisation under the mask, the placing), from the traced pass of the
template-matching driver."""

from portbench.metrics import _match


def read(record):
    return _match.match_ms(record, "rotate_ms")
