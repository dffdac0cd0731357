"""Worked examples of the port, each a module run as

    python -m gravity_tpu_torch.examples.<name> [--device cpu] ...

Counterparts of the JAX package's ``examples/`` scripts, with their flags
and printed markers: ``solar_system`` (an Earth year's orbital closure),
``galaxy_merger`` (two disks merging, the energy drift), ``star_cluster``
(a hard binary in a Plummer sphere under the rung ladder), ``cosmology``
(the linear growth curve in a periodic box), ``field_probe`` (a disk's
field on a probe grid through the rectangular FMM), ``gradient_orbit_fit``
(a transfer-orbit fit through the served ``fit`` job class) and
``plot_trajectory`` (a PNG of a recorded trajectory; needs matplotlib).
Each runs on the GPU unless ``--device cpu`` asks for the CPU.
"""
