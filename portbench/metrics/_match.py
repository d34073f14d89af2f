"""What the template-matching readers share: the traced pass's numbers an
orientation, as the driver (``drivers/template_match.py``) records them
under ``trace.match_ms``."""


def match_ms(record, key):
    """``trace.match_ms[key]``, or None where the record holds none."""
    return ((record.get("trace") or {}).get("match_ms") or {}).get(key)
