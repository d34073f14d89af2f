"""correlate_ms.tm: device ms an orientation under the program's span
match.correlate (the tomogram-sized rfftn, the product with the
tomogram's spectrum, the irfftn), from the template-matching driver's
traced pass."""

from portbench.metrics import _match


def read(record):
    return _match.match_ms(record, "correlate_ms")
