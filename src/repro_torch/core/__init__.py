"""FedOCS core: quantize (Eq. 7 codes), ocs (the noisy Alg. 1 core),
fedocs (the pooling laws), channel (communication-load accounting) and
vertical (the split encoder/fusion-head learner)."""
