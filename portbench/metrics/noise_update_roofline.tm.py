"""noise_update_roofline.tm: the noise map's least update time at the
published peaks (roofline/matching_rpc.py: the noise correlation, the
1 / sigma map and the noise map read once, 12 bytes a voxel) over the
device time an orientation under the program's span match.noise_update
(one launch of the update kernel's max-only entry), from the traced pass
of the random-phase template-matching driver, %."""

from portbench.metrics import _match


def read(record):
    least = _match.match_ms(record, "noise_update_least_ms")
    spent = _match.match_ms(record, "noise_update_ms")
    if least is None or not spent:
        return None
    return 100.0 * least / spent
