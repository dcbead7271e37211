"""Data parallelism over processes: the mesh (``mesh.py``) and a spawned
multi-process dry run on the CPU (``dryrun.py``)."""
