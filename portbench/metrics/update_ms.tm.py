"""update_ms.tm: device ms an orientation under the program's span
match.update (the score, and the best-score and index maps' update), from
the template-matching driver's traced pass."""

from portbench.metrics import _match


def read(record):
    return _match.match_ms(record, "update_ms")
