"""sigma_ms.tm: device ms an orientation under the program's span
match.sigma (the rotated mask's tomogram-sized forward, its products with
the spectra of the tomogram and of its square, their two irfftn, the
orientation's 1 / (N n sigma) map), from the traced pass of the
non-spherical template-matching driver."""

from portbench.metrics import _match


def read(record):
    return _match.match_ms(record, "sigma_ms")
