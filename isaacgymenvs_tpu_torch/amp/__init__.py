"""Adversarial motion priors: the motion library of reference clips."""
