"""Port parity: every drill of the reference's ``tests/test_zoo.py``, run
through both packages' artifact zoos with the same injected clock and the
same fault-injection spec.  Each drill logs the zoo's ``health()``, the
breakers' states and every typed error it meets; the two logs must be
equal, and the drill's own checks hold for both."""

import asyncio

import numpy as np
import pytest

import repro.runtime.faults as ref_faults
import repro.runtime.gateway as ref_gateway
import repro.runtime.zoo as ref_zoo
import repro_torch.runtime.faults as port_faults
import repro_torch.runtime.gateway as port_gateway
import repro_torch.runtime.zoo as port_zoo

pytestmark = pytest.mark.gateway

PACKAGES = {"reference": (ref_zoo, ref_faults, ref_gateway),
            "port": (port_zoo, port_faults, port_gateway)}


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Drill:
    """One package's zoo module, fault injector and gateway, plus the log."""

    def __init__(self, package):
        self.Z, self.faults, self.gateway = PACKAGES[package]
        self.clk = Clock()
        self.log = []
        self.loaded = []

    def zoo(self, **kw):
        def loader(tenant):
            self.loaded.append(tenant)
            return f"model:{tenant}", 100      # every artifact "weighs" 100 B

        return self.Z.ArtifactZoo(loader, clock=self.clk, **kw)

    def breaker(self, **kw):
        return self.Z.CircuitBreaker(clock=self.clk, **kw)

    def inject(self, spec):
        return self.faults.injected(spec)

    def attempt(self, fn):
        """Run ``fn``; log and return its value or its typed error."""
        try:
            out = ("ok", fn())
        except Exception as e:  # noqa: BLE001 — the error IS the record
            out = (type(e).__name__, getattr(e, "shed_reason", None), str(e))
        self.log.append(out)
        return out

    def lease(self, zoo, tenant):
        def go():
            with zoo.lease(tenant) as obj:
                return obj
        return self.attempt(go)

    def note(self, zoo=None, br=None):
        if zoo is not None:
            self.log.append(zoo.health())
        if br is not None:
            self.log.append((br.state, br.trips, br.consecutive, br.retry_at,
                             br.retry_in))


# -- the drills of tests/test_zoo.py, one function each -----------------------

def lru_eviction_under_byte_cap(d):
    zoo = d.zoo(capacity_bytes=250)
    for t in ("a", "b", "c"):
        d.lease(zoo, t)
        d.note(zoo)
    assert sorted(zoo._entries) == ["b", "c"] and zoo.evictions == 1
    d.lease(zoo, "b")
    d.lease(zoo, "d")
    assert sorted(zoo._entries) == ["b", "d"]
    d.lease(zoo, "a")
    d.note(zoo)
    assert d.loaded == ["a", "b", "c", "d", "a"]


def eviction_never_targets_pinned_entry(d):
    zoo = d.zoo(max_entries=1)
    with zoo.lease("t0") as obj0:
        with zoo.lease("t1"):
            d.note(zoo)
            assert "t0" in zoo._entries and obj0 == "model:t0"
    d.note(zoo)
    assert len(zoo._entries) <= 1


def evict_inflight_drill_defers_until_release(d):
    zoo = d.zoo(max_entries=1)
    with d.inject("zoo.evict_inflight*1"):
        with zoo.lease("t0"):
            with zoo.lease("t1"):
                d.note(zoo)
                assert zoo._entries["t0"].evict_on_release
            d.note(zoo)
        assert "t0" not in zoo._entries
    d.note(zoo)
    assert zoo.deferred_evictions == 1 and zoo.evictions >= 1


def breaker_open_half_open_close_transitions(d):
    br = d.breaker(threshold=2, cooldown=10.0)
    d.log.append(br.allow())
    for dt in (None, None, 9.9, 0.2):
        if dt is None:
            br.record_failure()
        else:
            d.clk.advance(dt)
            d.log.append(br.allow())
        d.note(br=br)
    br.record_success()
    d.note(br=br)
    assert br.state == d.Z.CLOSED and br.trips == 0


def breaker_failed_probe_doubles_backoff(d):
    br = d.breaker(threshold=1, cooldown=10.0)
    br.record_failure()
    d.note(br=br)
    for dt in (10.0, 20.0):
        d.clk.advance(dt)
        d.log.append(br.allow())
        br.record_failure()
        d.note(br=br)
    assert br.retry_at == d.clk() + 40.0


def breaker_backoff_is_capped(d):
    br = d.breaker(threshold=1, cooldown=10.0, max_cooldown=25.0)
    for _ in range(4):
        br.record_failure()
        d.clk.t = br.retry_at
        d.log.append(br.allow())
        d.note(br=br)
    assert br.retry_at - d.clk() <= 25.0


def breaker_failed_half_open_probe_retrips_through_lease_path(d):
    zoo = d.zoo(breaker_threshold=1, breaker_cooldown=10.0)
    with d.inject("zoo.load_fail*2"):
        d.lease(zoo, "t0")
        br = zoo.breakers["t0"]
        d.note(zoo, br)
        d.lease(zoo, "t0")                 # still cooling down
        d.clk.advance(10.0)
        d.lease(zoo, "t0")                 # half-open probe fails
        d.note(zoo, br)
        assert br.retry_at == d.clk() + 20.0
    d.clk.advance(20.0)
    d.lease(zoo, "t0")
    zoo.record_success("t0")
    d.note(zoo, br)
    assert br.state == d.Z.CLOSED and d.loaded == ["t0"]


def breaker_backoff_cap_through_lease_path(d):
    zoo = d.zoo(breaker_threshold=1, breaker_cooldown=10.0,
                breaker_max_cooldown=25.0)
    with d.inject("zoo.load_fail*5"):
        d.lease(zoo, "t0")
        br = zoo.breakers["t0"]
        for _ in range(4):
            d.clk.t = br.retry_at
            d.lease(zoo, "t0")
            d.note(zoo, br)
            assert br.retry_at - d.clk() <= 25.0
    d.clk.t = br.retry_at
    d.lease(zoo, "t0")
    zoo.record_success("t0")
    d.note(zoo, br)
    assert br.state == d.Z.CLOSED


def swap_is_atomic_and_inflight_leases_finish_on_old_version(d):
    zoo = d.zoo()
    with zoo.lease("t0") as obj:
        d.log.append((obj, zoo.version("t0")))
        d.log.append(zoo.swap("t0", "model:t0-v2", 100))
        assert obj == "model:t0"
        d.lease(zoo, "t0")
        d.note(zoo)
    d.note(zoo)
    assert zoo.health()["versions"] == {"t0": 2}


def swap_abort_drill_leaves_old_entry_bit_intact(d):
    zoo = d.zoo()
    d.lease(zoo, "t0")
    with d.inject("zoo.swap_abort*1"):
        d.attempt(lambda: zoo.swap("t0", "model:t0-v2", 100))
    d.note(zoo)
    assert d.lease(zoo, "t0") == ("ok", "model:t0")
    d.log.append(zoo.swap("t0", "model:t0-v2", 100))
    d.note(zoo)
    assert d.loaded == ["t0"]


def trip_force_opens_breaker_then_half_open_probe_admits(d):
    zoo = d.zoo(breaker_cooldown=10.0)
    d.lease(zoo, "t0")
    zoo.trip("t0")
    d.note(zoo)
    d.lease(zoo, "t0")
    d.clk.advance(10.0)
    d.lease(zoo, "t0")
    zoo.record_success("t0")
    d.note(zoo)
    assert zoo.breakers["t0"].state == d.Z.CLOSED


def load_fail_drill_quarantines_tenant(d):
    zoo = d.zoo(breaker_threshold=2, breaker_cooldown=10.0)
    with d.inject("zoo.load_fail*2"):
        for _ in range(2):
            assert d.lease(zoo, "t0")[1] == "load_failed"
    assert d.lease(zoo, "t0")[1] == "tenant_quarantined"
    d.note(zoo)
    d.clk.advance(50.0)
    d.lease(zoo, "t0")
    zoo.record_success("t0")
    d.note(zoo)
    assert zoo.breakers["t0"].state == d.Z.CLOSED


def load_fail_step_targets_tenant_by_trailing_digit(d):
    zoo = d.zoo()
    with d.inject("zoo.load_fail@2"):
        assert d.lease(zoo, "t1")[0] == "ok"
        assert d.lease(zoo, "t2")[0] == "ArtifactLoadError"
    d.note(zoo)


def engine_faults_reported_through_runner_trip_breaker(d):
    zoo = d.zoo(breaker_threshold=2, breaker_cooldown=10.0)

    def serve(obj, rows):
        if obj == "model:bad0":
            raise RuntimeError("engine exhausted")
        return np.zeros(len(rows), np.int64).tolist()

    run = zoo.runner(serve)
    for _ in range(3):
        d.attempt(lambda: run("bad0", [np.zeros(2)]))
    d.attempt(lambda: run("good1", [np.zeros(2)]))
    d.note(zoo)
    assert zoo.breakers["bad0"].state == d.Z.OPEN


def corrupt_tenant_quarantined_healthy_tenants_keep_serving(d):
    def loader(tenant):
        if tenant == "corrupt0":
            raise RuntimeError("checksum mismatch (simulated bit-rot)")
        return tenant, 64

    zoo = d.Z.ArtifactZoo(loader, breaker_threshold=2, clock=d.clk)
    run = zoo.runner(lambda obj, rows: np.array([int(r[0]) for r in rows]))

    async def go():
        gw = await d.gateway.Gateway(run, bucket=2, max_wait=0.01).start()
        futs = []
        for i in range(6):
            futs.append(gw.offer("corrupt0", np.array([i])))
            futs.append(gw.offer("good1", np.array([i])))
        res = await asyncio.gather(*futs)
        return res, await gw.drain()

    res, h = asyncio.run(go())
    d.log.append(sorted((r.tenant, r.ok, r.reason) for r in res))
    d.log.append((h["tenants"]["good1"]["answered"], h["unaccounted"]))
    d.note(zoo)
    assert h["unaccounted"] == 0 and h["tenants"]["good1"]["answered"] == 6


DRILLS = [
    lru_eviction_under_byte_cap,
    eviction_never_targets_pinned_entry,
    evict_inflight_drill_defers_until_release,
    breaker_open_half_open_close_transitions,
    breaker_failed_probe_doubles_backoff,
    breaker_backoff_is_capped,
    breaker_failed_half_open_probe_retrips_through_lease_path,
    breaker_backoff_cap_through_lease_path,
    swap_is_atomic_and_inflight_leases_finish_on_old_version,
    swap_abort_drill_leaves_old_entry_bit_intact,
    trip_force_opens_breaker_then_half_open_probe_admits,
    load_fail_drill_quarantines_tenant,
    load_fail_step_targets_tenant_by_trailing_digit,
    engine_faults_reported_through_runner_trip_breaker,
    corrupt_tenant_quarantined_healthy_tenants_keep_serving,
]


@pytest.mark.parametrize("drill", DRILLS, ids=lambda f: f.__name__)
def test_zoo_drill_matches_reference(drill):
    logs = {}
    for package in PACKAGES:
        d = Drill(package)
        drill(d)
        logs[package] = d.log
    assert logs["port"] == logs["reference"]
    assert logs["port"], "the drill logged nothing"


def test_zoo_exports_and_typed_errors():
    from repro_torch.runtime import ArtifactZoo, TenantQuarantined

    assert ArtifactZoo is port_zoo.ArtifactZoo
    assert TenantQuarantined.shed_reason == ref_zoo.TenantQuarantined.shed_reason
    assert port_zoo.ArtifactLoadError.shed_reason == "load_failed"
    # the loader plans through the port's autotuner: the reference's
    # keywords, with the device in place of the interpret flag
    import inspect
    ref_kw = set(inspect.signature(ref_zoo.artifact_loader).parameters)
    port_kw = set(inspect.signature(port_zoo.artifact_loader).parameters)
    assert port_kw == ref_kw - {"interpret"} | {"device"}
