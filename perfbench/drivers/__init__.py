"""Engines a mix can drive, one module each, named by the mix's
"driver" key: sequence (InferenceEngine, one request at a time) and
batch (BatchEngine, closed-loop clients over its slots)."""
