"""Data parallelism over processes (`parallel/mesh.py`) and its dry run
(`parallel/dryrun.py`)."""
