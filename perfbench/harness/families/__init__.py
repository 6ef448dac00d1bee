"""One module per family of models: how a job of that family runs, where
the output check records it, and the laws its draws are held to.

The harness loads ``<family>.py`` from the checkout by the ``family`` that a
configuration's file names (``spec.family``), so a family is added as a new
file. Its interface, which ``main``, ``replay``, ``check`` and the metric
readers use:

- ``WORK``: what its jobs count ("samples", "walks"), which the readers'
  ``of_family`` guards compare;
- ``build(graph, seed, cell, device)``: the model;
- ``job(model, cell, budget)``: one job, ``init`` then ``train()``, with
  ``budget`` as ``train()`` keyword arguments;
- ``hooks(rec)``: the recorder's wrappers (``record``) around the boundary
  between a step's draws and its update, by name: ``sgns_shared_negs_step``
  or LINE's ``multiblock_apply`` in the module that calls it;
- ``derived(model)``: what set-up derived from the graph that the law
  checks read;
- ``flops(cell, work)``: the SGNS operations of ``work`` units;
- ``law_checks(rec, derived, laws, cell, fault=False)``: (exact misses,
  z-scores, table distances).

Scope: a family plugs in when its model trains through ``TrainDriver``'s
captured calls on the SGNS tables ``vertex`` and ``context``: the job's
counters (``main._job_stats``), the kept replay (``replay.ReplayProbe``),
the reference's updates (``check``) and the community AUC
(``probes.community_auc`` of ``state["vertex"]``) read those. The models
with loops of their own (the KG models, the SASRec family, JODIE) do not.
"""
