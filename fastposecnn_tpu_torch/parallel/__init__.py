"""Data and tensor parallelism over processes (`parallel/mesh.py`, the
sharded convolutions of `parallel/tp.py`) and its dry run
(`parallel/dryrun.py`)."""
