"""One driver per kind of call loop; a traffic file names its driver."""
