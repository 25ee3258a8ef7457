"""Twins of the reference's ``examples/`` as modules of the port, each run
as ``python -m repro_torch.examples.<name>`` with ``--device`` ("cuda"
by default, which raises without a card; "cpu" to run without one):

    quickstart     the QR library in five minutes
    eigen_qr       eigenvalues by the QR algorithm (paper §1, Application 2)
    kalman_filter  a square-root Kalman filter on QR (paper §1, Application 1)
    serve_lm       batched prefill + decode over the gemma2 smoke config
    train_lm       QR-Muon training of smollm-135m, with the
                   fault-tolerance drill

Each writes only to its own output (and ``train_lm`` to its checkpoint
directory); none touches the reference's files.
"""
