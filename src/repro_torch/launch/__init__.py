"""Command-line launchers of the port: serving, training and the
train-step twin (``sim_accuracy``)."""
