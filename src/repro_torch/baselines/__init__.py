"""The design the paper measures itself against: Crane & Lin's postings in a
key-value store (:mod:`repro_torch.baselines.kvstore_search`)."""
