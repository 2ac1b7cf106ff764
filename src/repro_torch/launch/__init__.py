"""Launchers: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``; the device meshes (``mesh``), the
sharding policy (``sharding``), and the multi-pod dry-run
(``python -m repro_torch.launch.dryrun``) with its report
(``python -m repro_torch.launch.report``)."""
