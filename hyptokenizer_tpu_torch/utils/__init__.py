"""Host-side helpers of the port: data (cleaning, vocabulary, corpus
encoding, embedding init), morphology, ``TrainConfig``, metrics and
checkpoints."""
