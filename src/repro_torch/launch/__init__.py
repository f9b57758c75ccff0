"""Launch drivers (port of :mod:`repro.launch`): meshes (``mesh.py``),
training on any world ``make_host_mesh`` accepts (``train.py``) and the
multi-pod dry run (``dryrun.py``)."""
