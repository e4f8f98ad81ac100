"""The reference's five examples (``examples/*.py``) as the port's entry
points, each run as ``python -m repro_torch.examples.<name>``, on the card
unless ``--device cpu`` is given:

- ``quickstart``: the paper's main path, six (aggregator, attack) runs;
- ``attack_gallery``: Fig. 2's C1 x C2 separation per client;
- ``paper_grid``: a 48-cell results grid in one sweep;
- ``serve_decode``: teacher-forced then greedy decode on a SMOKE config;
- ``train_fl_llm``: fl-llm-100m federated through the round engine on a
  data x model mesh of local ranks.

Each ``main(argv=None)`` prints the reference's table and returns its
rows.
"""
