"""Launch drivers of the port: ``serve`` and ``train``
(``python -m repro_torch.launch.serve``), and the dry run: ``mesh``,
``specs``, ``dryrun`` (one rank's step traced on torch's fake process
group, no allocation) and ``roofline`` (the H100's three-term bound of
its reports)."""
