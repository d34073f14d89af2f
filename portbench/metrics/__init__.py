"""One reader per metric, named as the metric: ``read(record)``."""
