"""Admission layer of the port: features, GBDT predictor, policies and
the SJF queue."""
