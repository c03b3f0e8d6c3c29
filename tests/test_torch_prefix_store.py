"""The cluster prefix store of the port against the JAX package, on the CPU.

`cluster_chain`, the `Prefix*Msg` schemas, the GCS prefix table (each
package's own `GcsServer`, reached through the direct transport bridge of
tests/test_prefix_store.py: the handlers the wire hits, without sockets),
`ClusterPrefixStore`, the engines' publish and adopt, and the fleet
supervisor's owner hints, each run through the JAX original and the port
on the same inputs and weights (the tiny fp32 config of
tests/test_prefix_store.py). Bytes, tables, counters and tokens must be
IDENTICAL; adoption crosses the packages in both directions.
"""

import asyncio

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import engine as te
from ray_tpu_torch.llm import model_runner as tmr
from ray_tpu_torch.llm import prefix_store as tps
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.runtime import wire as twire
from ray_tpu_torch.runtime.gcs import server as tgcs

PKGS = ("jax", "port")


def _prompt(seed, n=17, vocab=128):
    return [(seed * 7 + 3 * i + seed) % vocab for i in range(n)]


@pytest.fixture(scope="module")
def weights(cpu_jax):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    jconfig = jl.LlamaConfig.tiny(vocab_size=128, max_seq=128,
                                  dtype=jnp.float32)
    jparams = jl.init_params(jconfig, jax.random.key(0))
    tconfig = tl.LlamaConfig.tiny(vocab_size=128, max_seq=128,
                                  dtype=torch.float32)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   tconfig, device="cpu")
    return jconfig, jparams, tconfig, tparams


def _mods(pkg):
    """(prefix_store, wire, GcsServer) of one package."""
    if pkg == "jax":
        from ray_tpu.llm import prefix_store
        from ray_tpu.runtime import wire
        from ray_tpu.runtime.gcs.server import GcsServer

        return prefix_store, wire, GcsServer
    return tps, twire, tgcs.GcsServer


def _gcs_bridge(pkg):
    """A GcsServer of `pkg` and a ClusterPrefixStore transport that calls
    its prefix handlers directly (tests/test_prefix_store.py's bridge)."""
    srv = _mods(pkg)[2]()

    def transport(method, m, payload=b""):
        r = asyncio.run(getattr(srv, f"handle_{method}")(None, m, payload))
        return r.m, r.payload

    return srv, transport


def _store(pkg, transport, **kw):
    return _mods(pkg)[0].ClusterPrefixStore(8, transport=transport, **kw)


def _engine(pkg, weights, num_blocks=16, host_capacity=8 << 20,
            cluster_store=None, low_watermark=0.8):
    """A fresh engine of `pkg` with the tiers of tests/test_prefix_store.py
    (host_capacity 0: no host tier)."""
    jconfig, jparams, tconfig, tparams = weights
    if pkg == "jax":
        from ray_tpu.llm.engine import LLMEngine
        from ray_tpu.llm.model_runner import ModelRunner
        from ray_tpu.llm.prefix_store import HostPrefixTier

        runner = ModelRunner(jconfig, jparams, num_blocks=num_blocks,
                             block_size=8, chunk_size=8)
        engine = LLMEngine(runner, max_batch_size=4, prefill_chunk=8,
                           enable_prefix_caching=True)
    else:
        HostPrefixTier = tps.HostPrefixTier
        runner = tmr.ModelRunner(tconfig, tparams, num_blocks=num_blocks,
                                 block_size=8, chunk_size=8, device="cpu")
        engine = te.LLMEngine(runner, max_batch_size=4, prefill_chunk=8,
                              enable_prefix_caching=True)
    tier = (HostPrefixTier(host_capacity, low_watermark=low_watermark)
            if host_capacity else None)
    engine.attach_prefix_store(host_tier=tier, cluster_store=cluster_store)
    return engine


def _params(pkg, **kw):
    if pkg == "jax":
        from ray_tpu.llm.sampling import SamplingParams as JaxParams

        return JaxParams(**kw)
    return SamplingParams(**kw)


def _greedy(pkg, engine, prompt, n=6):
    return engine.generate([prompt], _params(pkg, max_tokens=n,
                                             temperature=0.0))[0] \
        .output_token_ids


def _row(row):
    return {k: (bytes(v) if isinstance(v, (bytes, bytearray, memoryview))
                else v) for k, v in row.items() if k != "time"}


def _table(srv):
    """(rows in LRU order without their timestamps, bytes held)."""
    tbl = getattr(srv, "_prefix_entries", None) or {}
    return ([(k, _row(r)) for k, r in tbl.items()],
            getattr(srv, "_prefix_bytes", 0))


# ---- addresses and messages ----------------------------------------------

@pytest.mark.parametrize("lora", ["", "adapter-a"], ids=["base", "lora"])
def test_cluster_chain_equals_jax(cpu_jax, lora):
    """The fixed-salt digest chain of a prompt (every full block, the tail
    dropped) is the JAX package's, with and without an adapter seed."""
    from ray_tpu.llm import prefix_store as jps

    for n in (0, 7, 8, 17, 40):
        tokens = _prompt(n + 3, n=n)
        assert tps.cluster_chain(tokens, 8, lora) == \
            jps.cluster_chain(tokens, 8, lora)
        assert len(tps.cluster_chain(tokens, 8, lora)) == n // 8
    assert tps.cluster_chain(list(range(16)), 8, lora) != \
        tps.cluster_chain(list(range(16)), 8, lora + "x")
    assert tps.CLUSTER_PREFIX_SALT == jps.CLUSTER_PREFIX_SALT


def _msgs(wire):
    entry = dict(digest=b"\x01" * 16, lora_id="a0", weights_version=3,
                 block_size=8, n_tokens=16, token_ids=list(range(16)),
                 nbytes=4242, owner_replica="123-abcdef",
                 node_id=b"\x07" * 28, deployment="llm")
    return {
        "entry": wire.PrefixEntryMsg(**entry),
        "lookup": wire.PrefixLookupMsg(
            digests=[b"\x01" * 16, b"\x02" * 16], lora_id="a0",
            weights_version=3, block_size=8, want_payload=True,
            replica="r-1"),
        "reply": wire.PrefixLookupReplyMsg(
            found=True, entries=[wire.PrefixEntryMsg(**entry)] * 2,
            error=""),
        "purge": wire.PrefixPurgeMsg(
            owner_replica="r-1", node_id=b"\x07" * 28, deployment="llm",
            digests=[b"\x03" * 16], below_weights_version=2,
            clear_owner_only=True),
        "purge_reply": wire.PrefixPurgeReplyMsg(ok=True, purged=2,
                                                owners_cleared=5),
        "ack": wire.AckMsg(ok=False, error="empty prefix upsert",
                           existed=True),
    }


@pytest.mark.parametrize("name", ["entry", "lookup", "reply", "purge",
                                  "purge_reply", "ack"])
def test_prefix_messages_encode_as_jax(cpu_jax, name):
    """Each prefix-table message encodes to JAX's bytes, and each package
    decodes the other's."""
    from ray_tpu.runtime import wire as jwire

    port, jax = _msgs(twire)[name], _msgs(jwire)[name]
    assert port.encode() == jax.encode()
    assert type(port).decode(jax.encode()).encode() == jax.encode()
    assert type(jax).decode(port.encode()).encode() == port.encode()


# ---- the GCS table ----------------------------------------------------------

def _table_script(pkg):
    """One upsert/lookup/purge sequence on a fresh table of `pkg` with a
    13.5 KB capacity (about three 4.4 KB rows): every reply's bytes and the
    table after every operation."""
    ps, wire, _ = _mods(pkg)
    srv, transport = _gcs_bridge(pkg)
    srv.PREFIX_STORE_CAPACITY = 13_500
    rng = np.random.default_rng(7)
    pages = [rng.standard_normal((2, 4, 1, 8, 8)).astype(np.float32)
             for _ in range(6)]

    def upsert(i, tokens, **kw):
        row = dict(lora_id="", weights_version=1, owner_replica=f"r{i % 2}",
                   node_id=bytes([65 + i % 2]) * 4,
                   deployment="llm" if i < 4 else "other")
        row.update(kw)
        chain = ps.cluster_chain(tokens, 8, row["lora_id"])
        m = wire.PrefixEntryMsg(
            digest=chain[-1] if chain else b"\x05" * 16,
            block_size=8, n_tokens=len(tokens), token_ids=tokens, nbytes=1,
            **row).encode()
        return transport("prefix_upsert", m,
                         ps.encode_pages({}, pages[i], pages[i] * 2))

    def lookup(tokens, **kw):
        q = dict(lora_id="", weights_version=1, block_size=8,
                 want_payload=True, replica="")
        q.update(kw)
        chain = ps.cluster_chain(tokens, 8, q["lora_id"])
        return transport("prefix_lookup",
                         wire.PrefixLookupMsg(digests=chain, **q).encode())

    def purge(**kw):
        return transport("prefix_purge", wire.PrefixPurgeMsg(**kw).encode())

    toks = [list(range(8 * i, 8 * i + 8)) for i in range(4)]
    chain2 = toks[0] + toks[1]
    ops = [
        lambda: upsert(0, toks[0]),
        lambda: upsert(1, chain2),
        lambda: upsert(2, toks[2], lora_id="a0", weights_version=2),
        lambda: lookup(chain2, replica="adopter"),
        lambda: lookup(chain2, want_payload=False, weights_version=0),
        lambda: lookup(chain2, weights_version=5),
        lambda: lookup(toks[2], lora_id="a0", weights_version=2),
        lambda: lookup(toks[2], weights_version=2),
        lambda: upsert(3, toks[3]),                # LRU-evicts a row
        lambda: upsert(1, chain2),                 # existed
        lambda: upsert(4, toks[1], deployment="other"),
        lambda: upsert(5, [], weights_version=1),  # empty: refused
        lambda: purge(owner_replica="r1", clear_owner_only=True),
        lambda: purge(node_id=b"A" * 4, clear_owner_only=True),
        lambda: lookup(chain2, want_payload=False, weights_version=0),
        lambda: purge(below_weights_version=2),
        lambda: purge(deployment="other"),
        lambda: purge(digests=[ps.cluster_chain(toks[3], 8)[-1]]),
        lambda: purge(),
    ]
    out = []
    for op in ops:
        m, payload = op()
        out.append((bytes(m), bytes(payload), _table(srv)))
    return out


def test_gcs_table_sequence_equals_jax(cpu_jax):
    """The same operations leave equal tables in both packages' GCS: rows,
    their LRU order and the bytes held, with byte-equal replies; the
    byte-capacity LRU evicted and the table ends empty."""
    port, jax = _table_script("port"), _table_script("jax")
    assert len(port) == len(jax)
    for i, (p, j) in enumerate(zip(port, jax)):
        assert p == j, f"operation {i}"
    sizes = [len(rows) for _, _, (rows, _) in port]
    assert max(sizes) == 3 and sizes[-1] == 0
    assert all(held <= 13_500 for _, _, (_, held) in port)


def test_gcs_refuses_no_prefix_handler(cpu_jax):
    """The three prefix handlers are ported: the port's GCS registers
    them and lists none of them as refused."""
    assert not {"prefix_upsert", "prefix_lookup", "prefix_purge"} & set(
        tgcs.UNPORTED_HANDLERS)
    srv = tgcs.GcsServer()
    for name in ("prefix_upsert", "prefix_lookup", "prefix_purge"):
        assert callable(getattr(srv, f"handle_{name}"))


# ---- the store's cases of tests/test_prefix_store.py ------------------------

def _case_stale(pkg):
    """test_cluster_stale_weights_never_adopted."""
    ps = _mods(pkg)[0]
    _, transport = _gcs_bridge(pkg)
    store = _store(pkg, transport, replica="r")
    tokens = list(range(8))
    pages = np.ones((2, 4, 1, 8, 16), dtype=np.float32)
    ok = store.publish({"tokens": tokens, "k": pages, "v": pages,
                        "lora_name": "", "weights_version": 1}, wait=True)
    chain = ps.cluster_chain(tokens, 8)
    stale = store.lookup_pages(chain, weights_version=2)
    probe = store.lookup_owner(chain)
    store.purge(below_weights_version=2, wait=True)
    return dict(ok=ok, stale=stale, probe=probe,
                after=store.lookup_owner(chain), stats=store.stats())


def _case_hint_vs_drop(pkg):
    """test_cluster_purge_owner_hint_vs_drop."""
    ps = _mods(pkg)[0]
    _, transport = _gcs_bridge(pkg)
    store = _store(pkg, transport, replica="dead-1", deployment="llm")
    tokens = list(range(8))
    pages = np.ones((2, 4, 1, 8, 16), dtype=np.float32)
    store.publish({"tokens": tokens, "k": pages, "v": pages,
                   "lora_name": "", "weights_version": 0}, wait=True)
    chain = ps.cluster_chain(tokens, 8)
    cleared = store.purge(owner_replica="dead-1", clear_owner_only=True,
                          wait=True)
    hint = store.lookup_owner(chain)
    reader = _store(pkg, transport, replica="")
    adoptable = len(reader.lookup_pages(chain, weights_version=0))
    dropped = store.purge(deployment="llm", wait=True)
    return dict(cleared=cleared, hint=hint, adoptable=adoptable,
                dropped=dropped, after=store.lookup_owner(chain))


def _case_node_death(pkg):
    """test_gcs_node_death_clears_owner_hints_same_tick. The port's GCS
    marks the node dead through `_mark_node_dead`, the path a lost node
    takes, and its owner hints are blank when that call returns; the JAX
    side prunes as its test does."""
    ps, wire, _ = _mods(pkg)
    srv, transport = _gcs_bridge(pkg)
    store = _store(pkg, transport, replica="r-on-node")
    pages = np.ones((2, 4, 1, 8, 16), dtype=np.float32)

    def publish(tokens, node):
        m = wire.PrefixEntryMsg(
            digest=ps.cluster_chain(tokens, 8)[-1], lora_id="",
            weights_version=0, block_size=8, n_tokens=len(tokens),
            token_ids=tokens, nbytes=1, owner_replica="r-on-node",
            node_id=node, deployment="llm").encode()
        transport("prefix_upsert", m, ps.encode_pages({}, pages, pages))

    publish(list(range(8)), b"nodeA")
    publish(list(range(8, 16)), b"nodeB")
    if pkg == "jax":
        srv._purge_prefix_entries(node_id=b"nodeA", clear_owner_only=True)
    else:
        srv._nodes[b"nodeA"] = tgcs.NodeRecord(
            b"nodeA", ("127.0.0.1", 1), {"CPU": 1.0}, "", False, {})
        asyncio.run(srv._mark_node_dead(b"nodeA", "test"))
        assert not srv._nodes[b"nodeA"].alive
    return dict(
        a=store.lookup_owner(ps.cluster_chain(list(range(8)), 8)),
        b=store.lookup_owner(ps.cluster_chain(list(range(8, 16)), 8)),
        adoptable=len(store.lookup_pages(
            ps.cluster_chain(list(range(8)), 8), weights_version=0)))


def _case_capacity(pkg):
    """test_gcs_table_byte_capacity_lru."""
    ps = _mods(pkg)[0]
    srv, transport = _gcs_bridge(pkg)
    srv.PREFIX_STORE_CAPACITY = 13_500
    store = _store(pkg, transport, replica="r")
    pages = np.ones((2, 4, 1, 8, 8), dtype=np.float32)
    chains, oks = [], []
    for i in range(5):
        tokens = list(range(8 * i, 8 * i + 8))
        chains.append(ps.cluster_chain(tokens, 8))
        oks.append(store.publish({"tokens": tokens, "k": pages, "v": pages,
                                  "lora_name": "", "weights_version": 0},
                                 wait=True))
    return dict(oks=oks, held=srv._prefix_bytes,
                present=[store.lookup_owner(c) is not None for c in chains])


CASES = {"stale": _case_stale, "hint_vs_drop": _case_hint_vs_drop,
         "node_death": _case_node_death, "capacity": _case_capacity}


@pytest.mark.parametrize("case", sorted(CASES))
def test_store_cases_hold_as_jax(cpu_jax, case):
    """Each cluster-store case of tests/test_prefix_store.py gives the port
    what it gives the JAX package, and the port meets that test's
    assertions."""
    got = {pkg: CASES[case](pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    g = got["port"]
    if case == "stale":
        assert g["ok"] and g["stale"] == [] and g["after"] is None
        assert g["probe"]["owner_replica"] == "r"
        assert g["stats"]["stale_rejected"] == 0   # refused by the GCS
    elif case == "hint_vs_drop":
        assert g["cleared"] == 1 and g["hint"]["owner_replica"] == ""
        assert g["adoptable"] == 1 and g["dropped"] == 1
        assert g["after"] is None
    elif case == "node_death":
        assert g["a"]["owner_replica"] == ""
        assert g["b"]["owner_replica"] == "r-on-node"
        assert g["adoptable"] == 1
    else:
        assert all(g["oks"]) and g["held"] <= 13_500
        assert g["present"][0] is False and g["present"][-1] is True


def test_stale_row_rejected_by_the_client_too(cpu_jax):
    """A reply row of other weights is refused on the client as well (the
    adopter re-checks each row): the run stops there, counted as stale in
    both packages."""
    got = {}
    for pkg in PKGS:
        ps, wire, _ = _mods(pkg)
        pages = np.ones((2, 4, 1, 8, 16), dtype=np.float32)
        tokens = list(range(16))
        chain = ps.cluster_chain(tokens, 8)
        rows = [wire.PrefixEntryMsg(
            digest=chain[j], lora_id="", weights_version=[3, 4][j],
            block_size=8, n_tokens=8 * (j + 1),
            token_ids=tokens[:8 * (j + 1)], nbytes=1, owner_replica="o",
            deployment="llm") for j in range(2)]
        reply = wire.PrefixLookupReplyMsg(found=True, entries=rows).encode()
        payload = ps.encode_pages({}, pages, pages) * 2
        store = _store(pkg, lambda method, m, p=b"": (reply, payload))
        out = store.lookup_pages(chain, weights_version=3)
        got[pkg] = ([e["tokens"] for e in out], store.stats())
    assert got["port"] == got["jax"]
    assert got["port"][0] == [list(range(8))]
    assert got["port"][1]["stale_rejected"] == 1


# ---- engines: publish, adopt, refuse ----------------------------------------

def _survivor(pkg, weights):
    """test_survivor_adopts_spilled_prefix_bit_identical on one package's
    engines and table."""
    _, transport = _gcs_bridge(pkg)
    owner_store = _store(pkg, transport, replica="owner", deployment="llm")
    owner = _engine(pkg, weights, cluster_store=owner_store,
                    host_capacity=48 << 10, low_watermark=0.3)
    system = _prompt(1, n=24)
    a1 = system + _prompt(2, n=6)
    ref = _greedy(pkg, owner, a1)
    for s in range(3, 8):
        _greedy(pkg, owner, _prompt(s, n=40))
    surv_store = _store(pkg, transport, replica="survivor", deployment="llm")
    survivor = _engine(pkg, weights, host_capacity=0,
                       cluster_store=surv_store)
    before = survivor.prefill_tokens_computed
    out = _greedy(pkg, survivor, a1)
    stats = survivor.stats()
    keys = [k for k in stats if k.startswith("cluster_prefix_")]
    return dict(ref=ref, out=out, published=owner_store.published,
                owner_host={k: v for k, v in owner.stats().items()
                            if k.startswith("host_prefix_")},
                computed=survivor.prefill_tokens_computed - before,
                stats={k: stats[k] for k in keys + [
                    "prefix_hits", "prefix_tokens_saved", "free_kv_blocks"]})


def test_survivor_adopts_bit_identically_as_jax(weights):
    """The owner's host tier demotes into the table under filler traffic;
    a survivor with a fresh pool serves the shared prompt from the table:
    the owner's tokens, no prefill for the adopted blocks, and the same
    counters as the JAX engines."""
    got = {pkg: _survivor(pkg, weights) for pkg in PKGS}
    assert got["port"] == got["jax"]
    g = got["port"]
    assert g["out"] == g["ref"] and g["published"] >= 3
    assert g["stats"]["cluster_prefix_hits"] >= 3
    assert g["stats"]["cluster_prefix_tokens_saved"] >= 24
    assert g["stats"]["cluster_prefix_adopted_blocks"] >= 3
    assert g["computed"] <= 30 + 1 - 24


def _forged(pkg, weights):
    """test_forged_table_tokens_rejected_at_adoption."""
    ps, wire, _ = _mods(pkg)
    _, transport = _gcs_bridge(pkg)
    system = _prompt(1, n=8)
    pages = np.zeros((2, 4, 1, 8, 16), dtype=np.float32)
    m = wire.PrefixEntryMsg(
        digest=ps.cluster_chain(system, 8)[-1], lora_id="",
        weights_version=0, block_size=8, n_tokens=8, token_ids=[99] * 8,
        nbytes=1, owner_replica="evil", deployment="llm").encode()
    transport("prefix_upsert", m, ps.encode_pages({}, pages, pages))
    engine = _engine(pkg, weights, host_capacity=0,
                     cluster_store=_store(pkg, transport, replica="victim"))
    out = _greedy(pkg, engine, system + [5], n=4)
    plain = _greedy(pkg, _engine(pkg, weights, host_capacity=0),
                    system + [5], n=4)
    return dict(out=out, plain=plain, hits=engine.cluster_prefix_hits,
                fetched=engine.cluster_store.adopted_blocks)


def test_forged_table_tokens_rejected_as_jax(weights):
    """A row whose tokens are not the prompt's is never scattered: the
    engine prefills as if the table were empty, in both packages."""
    got = {pkg: _forged(pkg, weights) for pkg in PKGS}
    assert got["port"] == got["jax"]
    g = got["port"]
    assert g["hits"] == 0 and g["out"] == g["plain"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_adoption_crosses_the_packages(weights, direction):
    """One package's owner engine publishes into its own package's GCS
    table; the other package's survivor, bridged to that same table,
    adopts the prefix and gives the owner's greedy tokens exactly, with no
    prefill for the adopted blocks."""
    owner_pkg, surv_pkg = (("jax", "port") if direction == "jax_to_port"
                           else ("port", "jax"))
    srv, transport = _gcs_bridge(owner_pkg)
    owner_store = _store(owner_pkg, transport, replica="owner",
                         deployment="llm")
    owner = _engine(owner_pkg, weights, cluster_store=owner_store,
                    host_capacity=48 << 10, low_watermark=0.3)
    system = _prompt(4, n=32)
    request = system + _prompt(5, n=5)
    ref = _greedy(owner_pkg, owner, request, n=8)
    for s in range(10, 15):
        _greedy(owner_pkg, owner, _prompt(s, n=40))
    assert owner_store.published >= 4
    survivor = _engine(surv_pkg, weights, host_capacity=0,
                       cluster_store=_store(surv_pkg, transport,
                                            replica="survivor",
                                            deployment="llm"))
    before = survivor.prefill_tokens_computed
    out = _greedy(surv_pkg, survivor, request, n=8)
    assert out == ref
    assert survivor.cluster_prefix_hits == 4
    assert survivor.prefill_tokens_computed - before == len(request) - 32
    # The adopter became the table's live-owner hint.
    ps = _mods(owner_pkg)[0]
    assert owner_store.lookup_owner(
        ps.cluster_chain(system, 8))["owner_replica"] == "survivor"


def test_update_weights_purges_older_rows_as_jax(weights):
    """A weight swap GCs the table's rows below the new version, and the
    engine's next lookup asks for that version."""
    got = {}
    for pkg in PKGS:
        srv, transport = _gcs_bridge(pkg)
        store = _store(pkg, transport, replica="o", deployment="llm")
        engine = _engine(pkg, weights, cluster_store=store,
                         host_capacity=48 << 10, low_watermark=0.3)
        for s in range(3, 11):
            _greedy(pkg, engine, _prompt(s, n=40))
        rows = len(_table(srv)[0])
        params = weights[1] if pkg == "jax" else weights[3]
        version = engine.update_weights(params)["version"]
        got[pkg] = (rows > 0, version, len(_table(srv)[0]))
    assert got["port"] == got["jax"] == (True, 1, 0)


def _seeded(weights, seed):
    """`weights` with the port's parameters drawn from another seed: a
    model of the same shape and other weights."""
    tconfig = weights[2]
    return weights[:3] + (tl.init_params(
        tconfig, torch.Generator().manual_seed(seed), "cpu"),)


def test_other_models_rows_are_never_adopted(weights):
    """Two servers of one shape and other weights (seeds) share a table
    and a system prompt: neither adopts the other's rows (each row carries
    its publisher's model fingerprint), each gives its own model's tokens,
    and a server of the publisher's weights does adopt them."""
    models = {seed: _seeded(weights, seed) for seed in (1, 2)}
    system = _prompt(6, n=24)
    request = system + _prompt(7, n=6)
    for owner_seed, other_seed in ((1, 2), (2, 1)):
        _, transport = _gcs_bridge("port")
        owner_store = _store("port", transport, replica="owner",
                             deployment="llm")
        owner = _engine("port", models[owner_seed],
                        cluster_store=owner_store, host_capacity=48 << 10,
                        low_watermark=0.3)
        ref = _greedy("port", owner, request)
        for s in range(3, 8):
            _greedy("port", owner, _prompt(s, n=40))
        assert owner_store.published >= 3
        other = _engine("port", models[other_seed], host_capacity=0,
                        cluster_store=_store("port", transport,
                                             replica="other"))
        plain = _greedy("port", _engine("port", models[other_seed],
                                        host_capacity=0), request)
        assert other.model_fingerprint != owner.model_fingerprint
        assert _greedy("port", other, request) == plain != ref
        assert other.cluster_prefix_hits == 0
        assert other.cluster_store.stats()["stale_rejected"] == 1
        same = _engine("port", models[owner_seed], host_capacity=0,
                       cluster_store=_store("port", transport,
                                            replica="same"))
        assert _greedy("port", same, request) == ref
        assert same.cluster_prefix_hits == 3


def test_table_fetch_gate_learns_both_costs(weights):
    """The table is asked while either cost is unknown, and the first
    fetch measures a block's cost; while a fetched block costs more than
    prefilling it the engine prefills instead (its tokens unchanged), and
    every FETCH_REPROBE-th refused fetch goes ahead."""
    _, transport = _gcs_bridge("port")
    owner = _engine("port", weights, host_capacity=48 << 10,
                    low_watermark=0.3, cluster_store=_store(
                        "port", transport, replica="owner"))
    system = _prompt(1, n=24)
    request = system + _prompt(2, n=6)
    ref = _greedy("port", owner, request)
    for s in range(3, 8):
        _greedy("port", owner, _prompt(s, n=40))

    def survivor():
        return _engine("port", weights, host_capacity=0,
                       cluster_store=_store("port", transport,
                                            replica="survivor"))

    first = survivor()
    assert first._fetch_s_per_block is None
    assert _greedy("port", first, request) == ref
    assert first.cluster_prefix_hits == 3 and first._fetch_s_per_block > 0
    dear = survivor()
    dear._fetch_s_per_block, dear._prefill_s_per_token = 1.0, 1e-6
    assert _greedy("port", dear, request) == ref
    assert dear.cluster_prefix_hits == 0
    assert dear.stats()["table_fetches_skipped"] == 1
    reprobe = survivor()
    reprobe._fetch_s_per_block, reprobe._prefill_s_per_token = 1.0, 1e-6
    reprobe.table_fetches_skipped = te.FETCH_REPROBE - 1
    assert _greedy("port", reprobe, request) == ref
    assert reprobe.cluster_prefix_hits == 3
    # A cold prefill of a block or more is a sample of a token's cost.
    _greedy("port", dear, _prompt(30, n=40))
    assert 0 < dear._prefill_s_per_token != 1e-6


def _owned_bytes(a) -> tuple:
    """(id, bytes) of the buffer that keeps host array `a` alive."""
    while isinstance(a, np.ndarray) and a.base is not None:
        a = a.base
    if isinstance(a, torch.Tensor):
        st = a.untyped_storage()
        return st.data_ptr(), st.nbytes()
    return id(a), a.nbytes


def test_host_tier_keeps_only_the_bytes_it_counts(weights):
    """Spills of more blocks than the host tier holds, and promotions
    from it: the buffers its entries keep alive are each one block's and
    add up to the tier's byte count, within its capacity."""
    engine = _engine("port", weights, num_blocks=16, host_capacity=24 << 10)
    tier = engine.host_prefix_tier
    system = _prompt(9, n=97)
    kept = []
    for r in range(3):
        for s in range(3):
            _greedy("port", engine, _prompt(40 + 3 * r + s, n=40), n=3)
        _greedy("port", engine, system, n=3)
        owners = {}
        for e in tier._entries.values():
            for side in ("k", "v"):
                key, n = _owned_bytes(e[side])
                owners[key] = n
            assert _owned_bytes(e["k"]) == _owned_bytes(e["v"])
            assert _owned_bytes(e["k"])[1] == e["nbytes"]
        kept.append((sum(owners.values()), tier.bytes))
    assert tier.stats()["demotions"] > 0
    for held, counted in kept:
        assert held == counted <= tier.capacity_bytes


# ---- the host tier's promotion ----------------------------------------------

def _promotion(pkg, weights, scatters=None):
    """A 96-token system prompt is evicted from a 16-page pool by fillers
    and promoted back from the host tier, twice. Returns the tokens and
    counters (the engine's and the tier's own), and per promotion (its
    host hits, the scatters and gathers it made)."""
    engine = _engine(pkg, weights, num_blocks=16, host_capacity=1 << 20)
    if scatters is not None:
        for name in ("scatter_pages", "scatter_page_list",
                     "gather_page_list"):
            fn = getattr(engine.runner, name)

            def count(ids, *a, _fn=fn, _name=name):
                scatters.append((_name, list(ids)))
                return _fn(ids, *a)
            setattr(engine.runner, name, count)
    system = _prompt(9, n=97)
    out = [_greedy(pkg, engine, system, n=3)]
    rows = []
    for r in range(2):
        for s in range(3):
            out.append(_greedy(pkg, engine, _prompt(20 + 3 * r + s, n=40),
                               n=3))
        n0, hits0 = len(scatters or ()), engine.host_prefix_hits
        out.append(_greedy(pkg, engine, system, n=3))
        rows.append((engine.host_prefix_hits - hits0,
                     (scatters or [])[n0:]))
        stats = engine.stats()
        out.append({k: v for k, v in stats.items()
                    if k.startswith("host_prefix_") or k in (
                        "prefix_hits", "prefix_tokens_saved",
                        "prefill_tokens_computed", "free_kv_blocks")})
        out.append(engine.host_prefix_tier.stats())
    return out, rows


def test_host_promotion_is_one_scatter_and_equals_jax(weights):
    """The host tier's promotion walks the tier block by block as the JAX
    engine does (a block recycled during the walk spills, and the walk
    finds it), so tokens, blocks and every counter equal JAX's; the port
    writes a promotion's pages with ONE batched scatter."""
    jax_out, jax_rows = _promotion("jax", weights)
    scatters = []
    port_out, rows = _promotion("port", weights, scatters)
    assert port_out == jax_out
    assert [h for h, _ in rows] == [h for h, _ in jax_rows]
    assert port_out[0] == port_out[4] == port_out[10]
    assert port_out[6]["misses"] > 0
    assert rows[0][0] == 12     # 96 tokens: every block from the tier
    for hits, calls in rows:
        lists = [ids for name, ids in calls if name == "scatter_page_list"]
        assert hits > 0 and len(lists) == 1 and len(lists[0]) == hits
        # The walk's gather ahead (the first) holds no more parked blocks
        # than the walk took; the prompt's last page spills on its own.
        gathered = [ids for name, ids in calls if name == "gather_page_list"]
        assert gathered and len(gathered[0]) <= hits


# ---- the fleet supervisor ---------------------------------------------------

class _FakeReplica:
    def __init__(self, tag):
        self.tag = tag
        self.key = f"fake:{tag}"
        self.name = tag
        self.calls = []

    def call(self, method, *args, **kwargs):
        kwargs.pop("_timeout", None)
        self.calls.append((method, args))
        if method == "engine_stats":
            return {"replica": self.tag, "running": 0, "waiting": 0,
                    "prefilling": 0, "free_kv_blocks": 64,
                    "total_kv_blocks": 64}
        return {}


class _FakeStore:
    def __init__(self, owner=None):
        self.owner = owner
        self.purges = []
        self.lookups = []

    def purge(self, **kw):
        self.purges.append(kw)
        return -1

    def lookup_owner(self, digests, **kw):
        self.lookups.append((list(digests), kw))
        return ({"owner_replica": self.owner, "n_blocks": len(digests),
                 "n_tokens": 8} if self.owner else None)


def _fleet(pkg):
    """test_eject_blanks_cluster_owner_hint_same_tick and
    test_router_cluster_fallback_restores_affinity on one package's
    supervisor: purges, lookups, picks."""
    if pkg == "jax":
        from ray_tpu.llm.router import FleetSupervisor, RouterCore
    else:
        from ray_tpu_torch.llm.router import FleetSupervisor, RouterCore

    store = _FakeStore()
    sup = FleetSupervisor(RouterCore(2, block_size=8),
                          [_FakeReplica("rep-a"), _FakeReplica("rep-b")],
                          prefix_store=store)
    sup.fresh_stats(force=True)
    sup.eject_replica(0, reason="test")
    healthy = sup.core.is_healthy(0)
    sup.eject_replica(0)
    eject = dict(purges=store.purges, healthy=healthy)

    store = _FakeStore(owner="rep-b")
    core = RouterCore(2, block_size=8)
    sup = FleetSupervisor(core, [_FakeReplica("rep-a"),
                                 _FakeReplica("rep-b")], prefix_store=store)
    sup.fresh_stats(force=True)
    prompt = _prompt(1, n=16)
    idx = sup._cluster_affinity(prompt, {}, set())
    pick, decision = core.pick(prompt, stats=sup.fresh_stats())
    store.owner = "rep-gone"
    dead = sup._cluster_affinity(prompt, {}, set())
    tried = sup._cluster_affinity(prompt, {}, {1})
    return dict(eject=eject, idx=idx, pick=pick, reason=decision["reason"],
                dead=dead, tried=tried, lookups=store.lookups)


def test_fleet_supervisor_owner_hints_as_jax(cpu_jax):
    """Each package's supervisor blanks an ejected replica's owner hints
    once, in the ejection's tick, and maps a live hint to its replica
    (re-seeding its owner LRU) with the same lookups; a dead hint leaves
    the pow2 pick."""
    got = {pkg: _fleet(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    g = got["port"]
    assert g["eject"]["purges"] == [{"owner_replica": "rep-a",
                                     "clear_owner_only": True}]
    assert not g["eject"]["healthy"]
    assert g["idx"] == 1 and g["pick"] == 1 and g["reason"] == "prefix"
    assert g["dead"] is None and g["tried"] is None
