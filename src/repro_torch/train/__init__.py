"""Training: the train / eval steps and the fault-tolerant trainer."""
