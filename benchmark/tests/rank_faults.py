"""Rank functions with the timed path broken underneath, for
``test_harness_run`` (importable by name: the ranks are spawned)."""


def exchange_left_out(mesh, *args):
    """The exchange between ranks left out: each rank's gather returns its
    own block in every rank's place."""
    from climatemodel_tpu_torch.parallel import collectives
    collectives.fetch_shards = lambda mesh, xs, which: [xs[0]] * len(which)
    from drivers.grey_ranks import rank_window
    return rank_window(mesh, *args)


def state_unchanged(mesh, *args):
    """Every rank's march returns its members as they came, claiming
    equilibrium."""
    import torch

    from climatemodel_tpu_torch.models.column import EquilibriumInfo
    from climatemodel_tpu_torch.parallel import ensemble

    def march(mesh, states, forcings, *a, **k):
        B = states.T.shape[0]
        yes = torch.ones(B, dtype=torch.bool)
        no = torch.zeros(B, dtype=torch.bool)
        z = torch.zeros(B)
        if k.get('telemetry') is not None:
            k['telemetry']['iterations'] = [1]
        return states, EquilibriumInfo(
            steps=torch.ones(B, dtype=torch.int32), delta_net_flux=z,
            flux_thresh=z, failed=no, equilibrium=yes, nan=no, timed_out=no)
    ensemble.grey_evolve_ensemble_sharded = march
    from drivers.grey_ranks import rank_window
    return rank_window(mesh, *args)


def loads_jax(mesh, *args):
    """A rank that loads a module named ``jax`` (a stand-in, put in
    ``sys.modules``) before its window."""
    import sys
    import types
    sys.modules['jax'] = types.ModuleType('jax')
    from drivers.grey_ranks import rank_window
    return rank_window(mesh, *args)


def _wrap_march(change):
    """Every rank's gathered march result passed through ``change(states,
    fs)`` where it is produced."""
    from climatemodel_tpu_torch.parallel import ensemble
    real = ensemble.grey_evolve_ensemble_sharded

    def march(mesh, states, *a, **k):
        fs, info = real(mesh, states, *a, **k)
        return change(states, fs), info
    ensemble.grey_evolve_ensemble_sharded = march


def half_left_out(mesh, *args):
    """The second half of the sweep returned as it came, flagged as the
    marched members."""
    def change(states, fs):
        h = states.T.shape[0] // 2
        T, net = fs.T.clone(), fs.net_flux.clone()
        T[h:] = states.T[h:].to(T.device)
        net[h:] = states.net_flux[h:].to(net.device)
        return fs.replace(T=T, net_flux=net)
    _wrap_march(change)
    from drivers.grey_ranks import rank_window
    return rank_window(mesh, *args)


def answer_altered(mesh, *args):
    """One member's answer altered where it is produced."""
    def change(states, fs):
        T = fs.T.clone()
        T[0] *= 1.02
        return fs.replace(T=T)
    _wrap_march(change)
    from drivers.grey_ranks import rank_window
    return rank_window(mesh, *args)
