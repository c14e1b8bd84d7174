"""Build recipes, one file a recipe, named by a configuration's ``"build"``
key (``local`` without one). A recipe has

* ``build(ctx, group)``: on rank 0, builds what the rank serves and returns
  the retriever the traffic driver calls (``search_batch``);
* ``follow(ctx, group)``: on every other rank, builds the rank's part and
  serves rank 0 until rank 0 closes;
* ``leaves(ctx, group)``: on every rank, once the window has closed, the
  leaves of the index the rank served, as plain tensors: what the check
  judges;
* ``close(ctx, group)``, where the other ranks follow: on rank 0 after the
  window, ends their ``follow``.

``build`` and ``follow`` call ``group.built()`` once the rank's part of the
build is done, before anything serves: the barrier after every rank's
build. Each keeps what its rank serves in ``ctx.retr``."""
