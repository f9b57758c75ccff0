"""Launch drivers (port of :mod:`repro.launch`): meshes and training.
``launch/dryrun.py`` is not ported yet (``ROADMAP.md``)."""
