"""transforms.tm: the program's counter match.transforms (tomogram-sized
transforms launched) over its counter match.orientations, over the
template-matching driver's traced pass."""


def read(record):
    counts = (record.get("trace") or {}).get("counts") or {}
    if not counts.get("match.orientations"):
        return None
    return counts.get("match.transforms", 0) / counts["match.orientations"]
