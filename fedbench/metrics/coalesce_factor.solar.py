"""Updates folded per drain: the store's ``agg_stats()["coalesce_factor"]``
over the whole run."""


def read(ctx):
    value = ctx.stats.get("coalesce_factor")
    return value if value else None
