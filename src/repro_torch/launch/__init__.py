"""The port of :mod:`repro.launch`: the H100 constants and the production
meshes (:mod:`~repro_torch.launch.mesh`), the traced cost counts and the
roofline (:mod:`~repro_torch.launch.hlo_analysis`), and the meta-device
dry run (``python -m repro_torch.launch.dryrun``).  Importing it starts
no process group."""
