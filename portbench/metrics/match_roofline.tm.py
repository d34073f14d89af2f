"""match_roofline.tm: an orientation's least time at the published peaks
(roofline/matching.py: the tomogram's spectrum and sigma map read once,
the score and index maps read and written once, the two transforms'
operations) over its measured device time, all the device work under the
program's span match an orientation, %."""

from portbench.metrics import _match


def read(record):
    least = _match.match_ms(record, "least_ms")
    spent = _match.match_ms(record, "device_ms")
    if least is None or not spent:
        return None
    return 100.0 * least / spent
