"""The port's experiments: end-to-end validation runs over the package
(``python -m cokriging_tpu_torch sim`` runs ``simulation_experiment``)."""
