"""Multi-rank layouts over ``torch.distributed``: the ("tower", "coeff")
mesh, the distributed four-step NTT and its explicit collectives."""
