"""The benchmark's plain reference: the model (:mod:`.model`), the
training update (:mod:`.muon`), the inputs both sides get
(:mod:`.inputs`) and the comparison that decides ``correct``
(:mod:`.compare`).  It imports nothing of the program."""
