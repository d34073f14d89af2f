"""noise_ms.tm: device ms an orientation under the program's span
match.noise (the noise template's rotation, wedge, normalisation under the
mask, placing, forward, spectral pass and inverse at the tomogram), from
the traced pass of the random-phase template-matching driver."""

from portbench.metrics import _match


def read(record):
    return _match.match_ms(record, "noise_ms")
