"""The port's device layer (``elastic_tpu_agent_torch/device/``) on the CPU:
``NvidiaOperator`` against a temp dev root and a hand-written
``nvidia-smi -q -x`` listing of 8 H100 SXM5 cards whose node minors are
permuted against the listing's (PCI) order; the port's ``qos_env`` against the
agent's on one grid of inputs; and the subpackage importing neither torch
nor the agent."""

import os
import stat
import subprocess
import sys
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import qos as agent_qos  # noqa: E402
from elastic_tpu_agent.common import AnnotationRepartition  # noqa: E402
from elastic_tpu_agent_torch.device import (  # noqa: E402
    NvidiaOperator,
    OperatorError,
    StubOperator,
)
from elastic_tpu_agent_torch.device import qos as port_qos  # noqa: E402
from elastic_tpu_agent_torch.device.nvidia import (  # noqa: E402
    SMI_BOOT_RETRIES,
    SMI_BOOT_RETRY_DELAY_S,
    parse_bytes,
    parse_percent,
    run_nvidia_smi,
)
from elastic_tpu_agent_torch.device.topology import (  # noqa: E402
    CHIP_SPECS,
    FALLBACK_SPEC,
    MiB,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the i-th card of nvidia-smi's listing (PCI order) -> /dev/nvidia<minor>,
# its index: not the identity, as on a host whose nodes were numbered in
# another order than the PCI bus
MINORS = [3, 0, 7, 1, 6, 2, 5, 4]

SMI_HEAD = """<?xml version="1.0" ?>
<!DOCTYPE nvidia_smi_log SYSTEM "nvsmi_device_v12.dtd">
<nvidia_smi_log>
	<timestamp>Sat Oct 17 18:00:00 2026</timestamp>
	<driver_version>550.90.07</driver_version>
	<cuda_version>12.4</cuda_version>
	<attached_gpus>{n}</attached_gpus>
"""
SMI_GPU = """	<gpu id="00000000:{bus}:00.0">
		<product_name>{product}</product_name>
		<product_brand>NVIDIA</product_brand>
		<product_architecture>Hopper</product_architecture>
		<persistence_mode>Enabled</persistence_mode>
		<serial>165432100{i}</serial>
		<uuid>{uuid}</uuid>
		<minor_number>{minor}</minor_number>
		<vbios_version>96.00.99.00.01</vbios_version>
		<pci>
			<pci_bus>{bus}</pci_bus>
			<pci_device>00</pci_device>
			<pci_domain>0000</pci_domain>
			<pci_device_id>233010DE</pci_device_id>
			<pci_bus_id>00000000:{bus}:00.0</pci_bus_id>
		</pci>
		<fb_memory_usage>
			<total>{total}</total>
			<reserved>328 MiB</reserved>
			<used>{used} MiB</used>
			<free>80000 MiB</free>
		</fb_memory_usage>
		<compute_mode>Default</compute_mode>
		<utilization>
{util}			<memory_util>0 %</memory_util>
			<encoder_util>0 %</encoder_util>
		</utilization>
		<ecc_mode>
			<current_ecc>Enabled</current_ecc>
			<pending_ecc>Enabled</pending_ecc>
		</ecc_mode>
		<ecc_errors>
			<volatile>
				<sram_correctable>{sram_corr}</sram_correctable>
				<sram_uncorrectable_parity>0</sram_uncorrectable_parity>
				<sram_uncorrectable_secded>0</sram_uncorrectable_secded>
				<dram_correctable>0</dram_correctable>
				<dram_uncorrectable>{dram_unc}</dram_uncorrectable>
			</volatile>
			<aggregate>
				<sram_correctable>{sram_corr}</sram_correctable>
				<sram_uncorrectable_parity>0</sram_uncorrectable_parity>
				<sram_uncorrectable_secded>0</sram_uncorrectable_secded>
				<dram_correctable>0</dram_correctable>
				<dram_uncorrectable>{agg_unc}</dram_uncorrectable>
				<sram_threshold_exceeded>No</sram_threshold_exceeded>
			</aggregate>
		</ecc_errors>
		<retired_pages>N/A</retired_pages>
		<remapped_rows>
			<remapped_row_corr>0</remapped_row_corr>
			<remapped_row_unc>0</remapped_row_unc>
			<remapped_row_pending>No</remapped_row_pending>
			<remapped_row_failure>{remap}</remapped_row_failure>
		</remapped_rows>
	</gpu>
"""


def uuid_of(i):
    return f"GPU-5b2ee3a9-{i:04d}-7d1c-8e0f-0c3a9b1d2e{i:02d}"


class FakeHost:
    """8 H100 SXM5 cards: a dev root with their nodes and an nvidia-smi
    whose listing each test edits (``cards[i]`` holds card i's fields;
    a card set to None is not listed; while ``fail`` is above 0, a call
    fails and counts it down). The nodes are regular files; :meth:`stat`
    shows those named in ``char`` as character devices, and
    ``nvidia-uvm-tools`` stays a regular file, as a placeholder a host may
    hold."""

    def __init__(self, tmp_path, product="NVIDIA H100 80GB HBM3"):
        self.dev = str(tmp_path / "dev")
        os.makedirs(self.dev)
        for m in MINORS:
            open(os.path.join(self.dev, f"nvidia{m}"), "w").close()
        for n in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"):
            open(os.path.join(self.dev, n), "w").close()
        self.char = {"nvidiactl": (195, 255), "nvidia-uvm": (511, 0)}
        self.cards = [dict(i=i, bus=f"{0x18 + 0x10 * i:02X}",
                           product=product, uuid=uuid_of(i),
                           minor=MINORS[i], total="81559 MiB", used=0,
                           util=f"\t\t\t<gpu_util>{10 * i} %</gpu_util>\n",
                           sram_corr=0, dram_unc=0, agg_unc=0, remap="No")
                      for i in range(8)]
        self.calls = 0
        self.fail = 0

    def smi(self):
        self.calls += 1
        if self.fail:
            self.fail -= 1
            return None
        listed = [c for c in self.cards if c is not None]
        return (SMI_HEAD.format(n=len(listed))
                + "".join(SMI_GPU.format(**c) for c in listed)
                + "</nvidia_smi_log>\n")

    def stat(self, path):
        st = os.stat(path)
        rdev = self.char.get(os.path.basename(path))
        if rdev is None:
            return st
        return SimpleNamespace(st_mode=stat.S_IFCHR | 0o666,
                               st_rdev=os.makedev(*rdev))

    def operator(self, **kw):
        kw.setdefault("smi_ttl_s", 0.0)
        kw.setdefault("stat_fn", self.stat)
        return NvidiaOperator(
            self.dev, smi=self.smi, env=kw.pop("env", {}),
            maintenance=kw.pop("maintenance", lambda: None),
            preemption=kw.pop("preemption", lambda: None), **kw)


@pytest.fixture()
def host(tmp_path):
    return FakeHost(tmp_path)


def test_devices_follow_smi_order_with_permuted_minors(host):
    op = host.operator()
    chips = op.devices()
    assert [c.index for c in chips] == MINORS
    assert [c.device_path for c in chips] == [f"/dev/nvidia{m}"
                                             for m in MINORS]
    assert [c.uuid for c in chips] == [uuid_of(i) for i in range(8)]
    for c in chips:
        assert c.hbm_bytes == 81559 * MiB
        assert c.cores == 132
        assert c.extra_paths == ["/dev/nvidiactl", "/dev/nvidia-uvm"]
    topo = op.topology
    assert (topo.accelerator_type, topo.total_chips, topo.total_cores,
            topo.chips_per_host, topo.num_hosts, topo.is_multi_host) == (
        "NVIDIA H100 80GB HBM3", 8, 8 * 132, 8, 1, False)
    assert op.driver_version == "550.90.07"
    assert op.worker_id() == 0 and op.worker_hostnames() == []


def test_control_nodes_are_the_character_devices_only(host):
    """A control node counts only where the host holds it as a character
    device of a real major: a regular file under its name (here
    ``nvidia-uvm-tools``) or a node at 0:0 is a placeholder no runtime
    can hand to a container."""
    assert host.operator().devices()[0].extra_paths == [
        "/dev/nvidiactl", "/dev/nvidia-uvm"]
    host.char["nvidia-uvm"] = (0, 0)
    host.char["nvidia-uvm-tools"] = (511, 1)
    assert host.operator().devices()[0].extra_paths == [
        "/dev/nvidiactl", "/dev/nvidia-uvm-tools"]
    # with the real stat, the regular files count as none
    assert host.operator(stat_fn=os.stat).devices()[0].extra_paths == []
    os.unlink(os.path.join(host.dev, "nvidiactl"))
    assert host.operator().devices()[0].extra_paths == [
        "/dev/nvidia-uvm-tools"]


def test_links_target_minors_and_resolve_to_indexes(host, tmp_path):
    links = str(tmp_path / "links")
    os.makedirs(links)
    op = NvidiaOperator(links, host_dev_scan_root=host.dev, smi=host.smi,
                        env={}, maintenance=lambda: None,
                        preemption=lambda: None)
    for chip in op.devices():
        i = chip.index
        op.create(i, f"h{i}-0")
        path = os.path.join(links, f"elastic-tpu-h{i}-0")
        assert os.readlink(path) == chip.device_path == f"/dev/nvidia{i}"
        assert op.resolve(f"h{i}-0") == i
    op.create(5, "h5-0")                       # idempotent
    assert sorted(op.list_links()) == sorted(f"h{i}-0" for i in range(8))
    op.delete("h5-0")
    assert not op.check("h5-0") and op.resolve("h5-0") is None
    op.delete("h5-0")                          # a missing link is success
    assert op.check("h4-0")
    with pytest.raises(OperatorError):
        op.create(8, "nope-0")
    # a link retargeted to a node that no listed card has resolves to None
    os.replace(os.path.join(links, "elastic-tpu-h4-0"),
               os.path.join(links, "elastic-tpu-h4-0.bak"))
    os.symlink("/dev/nvidia9", os.path.join(links, "elastic-tpu-h4-0"))
    assert op.resolve("h4-0") is None


def test_health_when_a_node_is_removed(host):
    op = host.operator()
    assert op.healthy_indexes() == set(range(8))
    assert op.health_reasons() == {}
    os.unlink(os.path.join(host.dev, f"nvidia{MINORS[5]}"))
    assert op.healthy_indexes() == set(range(8)) - {MINORS[5]}
    assert op.health_reasons() == {MINORS[5]: f"device node "
                                              f"nvidia{MINORS[5]} missing"}


def test_health_when_an_uncorrectable_counter_rises(host):
    host.cards[3]["dram_unc"] = 2      # before the agent: the baseline
    op = host.operator()
    assert op.healthy_indexes() == set(range(8))
    host.cards[2]["sram_corr"] = 40    # correctable errors never count
    host.cards[4]["agg_unc"] = 9       # nor do aggregate counters
    assert op.healthy_indexes() == set(range(8))
    host.cards[3]["dram_unc"] = 3
    assert op.healthy_indexes() == set(range(8)) - {MINORS[3]}
    reason = op.health_reasons()[MINORS[3]]
    assert "ecc_errors/volatile/dram_uncorrectable" in reason
    assert "rose to 3" in reason
    host.cards[3]["dram_unc"] = 0      # sticky until the agent restarts
    assert op.healthy_indexes() == set(range(8)) - {MINORS[3]}


def test_health_counter_reset_rebaselines(host):
    host.cards[6]["dram_unc"] = 5
    op = host.operator()
    assert MINORS[6] in op.healthy_indexes()
    host.cards[6]["dram_unc"] = 0      # a driver reload resets it
    assert MINORS[6] in op.healthy_indexes()
    host.cards[6]["dram_unc"] = 1      # below the old baseline: counted
    assert MINORS[6] not in op.healthy_indexes()


def test_health_when_row_remapping_fails(host):
    op = host.operator()
    host.cards[6]["remap"] = "Yes"
    assert op.healthy_indexes() == set(range(8)) - {MINORS[6]}
    assert op.health_reasons() == {MINORS[6]: "row remapping failed"}
    host.cards[6]["remap"] = "No"
    assert op.healthy_indexes() == set(range(8))


def test_a_card_that_drops_out_keeps_every_index(host):
    op = host.operator()
    op.devices()
    host.cards[2] = None
    chips = op.devices()
    rest = [i for i in range(8) if i != 2]
    assert [c.index for c in chips] == [MINORS[i] for i in rest]
    assert [c.uuid for c in chips] == [uuid_of(i) for i in rest]
    assert op.healthy_indexes() == set(range(8)) - {MINORS[2]}
    assert op.health_reasons() == {MINORS[2]: "not listed by nvidia-smi"}
    assert op.minor_of(MINORS[7]) == MINORS[7]
    with pytest.raises(OperatorError):
        op.create(MINORS[2], "gone-0")


def test_a_restart_with_a_card_missing_keeps_every_index(host):
    """Indexes the agent stored before a restart name the same cards
    after it, though nvidia-smi now lists one card fewer. A node that no
    listing of this process has shown is neither advertised nor judged:
    a container's /dev may hold nodes of cards it cannot use."""
    before = {c.uuid: c.index for c in host.operator().devices()}
    host.cards[2] = None
    restarted = host.operator()
    after = {c.uuid: c.index for c in restarted.devices()}
    assert after == {u: i for u, i in before.items() if u != uuid_of(2)}
    assert restarted.healthy_indexes() == set(after.values())
    assert restarted.health_reasons() == {}


def test_a_failed_smi_call_keeps_the_last_listing(host):
    op = host.operator()
    chips = op.devices()
    counters = op.error_counters()
    assert op.healthy_indexes() == set(range(8))
    host.fail = 4                 # each read below calls nvidia-smi
    assert op.devices() == chips
    assert op.healthy_indexes() == set(range(8))
    assert op.health_reasons() == {}
    assert op.error_counters() == counters
    util = op.utilization()
    assert sorted(util) == list(range(8))
    assert all(set(e) == {"error"} for e in util.values())
    assert host.calls == 7 and host.fail == 0
    assert op.utilization()[MINORS[1]] == {"duty_cycle_percent": 10.0,
                                           "hbm_used_bytes": 0}


def test_the_first_read_retries_a_failed_smi_call(host):
    """With nvidia nodes present, a failed call at the first read is
    retried before the inventory reads empty, and only then."""
    slept = []
    host.fail = 2
    op = host.operator(sleep=slept.append)
    assert [c.index for c in op.devices()] == MINORS
    assert slept == [SMI_BOOT_RETRY_DELAY_S] * 2 and host.calls == 3
    host.fail, slept[:] = 10, []
    broken = host.operator(sleep=slept.append)
    assert broken.devices() == [] and len(slept) == SMI_BOOT_RETRIES
    assert broken.healthy_indexes() == set()
    assert broken.health_reasons() == {}
    assert len(slept) == SMI_BOOT_RETRIES   # none after the first read


def test_utilization_entries_and_errors(host):
    host.cards[1]["used"] = 20000
    host.cards[4]["util"] = "\t\t\t<gpu_util>N/A</gpu_util>\n"
    host.cards[7]["util"] = ""         # no gpu_util: no telemetry
    op = host.operator()
    util = op.utilization()
    assert sorted(util) == sorted(MINORS[:7])
    assert util[MINORS[1]] == {"duty_cycle_percent": 10.0,
                               "hbm_used_bytes": 20000 * MiB}
    assert util[MINORS[3]] == {"duty_cycle_percent": 30.0,
                               "hbm_used_bytes": 0}
    assert set(util[MINORS[4]]) == {"error"}
    assert "N/A" in util[MINORS[4]]["error"]


def test_error_counters_are_raw(host):
    host.cards[0]["agg_unc"] = 4
    counters = host.operator().error_counters()
    assert sorted(counters) == list(range(8))
    c0 = counters[MINORS[0]]
    assert c0["ecc_errors/aggregate/dram_uncorrectable"] == 4
    assert c0["ecc_errors/volatile/dram_uncorrectable"] == 0
    assert "ecc_errors/aggregate/sram_threshold_exceeded" not in c0


def test_one_smi_call_serves_every_read_within_the_ttl(host):
    op = host.operator(smi_ttl_s=60.0)
    op.devices()
    op.healthy_indexes()
    op.utilization()
    op.error_counters()
    op.minor_of(3)
    assert host.calls == 1
    uncached = host.operator()
    uncached.devices()
    uncached.utilization()
    assert host.calls == 3


@pytest.mark.parametrize("output", [None, "", "not xml <", "<a><b></a>"])
def test_no_or_broken_smi_gives_an_empty_inventory(tmp_path, output):
    op = NvidiaOperator(str(tmp_path), smi=lambda: output, env={},
                        maintenance=lambda: None, preemption=lambda: None)
    assert op.devices() == []
    assert op.healthy_indexes() == set()
    assert op.utilization() == {}
    assert op.error_counters() == {}
    assert op.topology is None
    with pytest.raises(OperatorError):
        op.create(0, "x-0")


def test_absent_nvidia_smi_binary_reads_none(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert run_nvidia_smi() is None


def test_unknown_card_never_over_advertises(tmp_path):
    host = FakeHost(tmp_path, product="NVIDIA Hypothetical 7")
    host.cards[0]["total"] = "N/A"
    chips = host.operator().devices()
    assert chips[0].hbm_bytes == FALLBACK_SPEC.hbm_bytes
    assert chips[1].hbm_bytes == 81559 * MiB   # measured wins
    assert {c.cores for c in chips} == {1}
    # the fallback lies below what any card in the table reports
    assert FALLBACK_SPEC.hbm_bytes <= min(
        s.hbm_bytes for s in CHIP_SPECS.values()) < 81559 * MiB


def test_worker_identity_and_multi_host_topology(host):
    op = host.operator(env={"TPU_WORKER_ID": "1",
                            "TPU_WORKER_HOSTNAMES": "h0,h1"})
    assert op.worker_id() == 1 and op.worker_hostnames() == ["h0", "h1"]
    topo = op.topology
    assert (topo.num_hosts, topo.total_chips, topo.is_multi_host) == (
        2, 16, True)
    assert host.operator(env={"TPU_WORKER_ID": "x"}).worker_id() == 0


def test_maintenance_and_preemption_polls_keep_ttl_and_backoff(host):
    calls = {"m": 0, "p": 0}
    answers = {"m": [None, "MIGRATE_ON_HOST_MAINTENANCE"], "p": ["TRUE"]}

    def fetch(key):
        def f():
            calls[key] += 1
            return answers[key].pop(0)
        return f

    op = host.operator(maintenance=fetch("m"), preemption=fetch("p"),
                       maintenance_poll_ttl_s=1000.0,
                       maintenance_error_backoff_s=0.0)
    assert op.maintenance_event() is None      # unreachable: backoff 0
    assert op.maintenance_event() == "MIGRATE_ON_HOST_MAINTENANCE"
    assert op.maintenance_event() == "MIGRATE_ON_HOST_MAINTENANCE"
    assert calls["m"] == 2                     # then cached for the TTL
    assert op.preempted() and op.preempted() and calls["p"] == 1


def test_parsers_tolerate_driver_spellings():
    assert parse_bytes("81559 MiB") == 81559 * MiB
    assert parse_bytes("80 GiB") == 80 * 1024 * MiB
    assert parse_bytes("N/A") is None and parse_bytes(None) is None
    assert parse_percent("37 %") == 37.0 and parse_percent("12.5%") == 12.5
    assert parse_percent("N/A") is None


def test_stub_minors_and_injection_seams(tmp_path):
    op = StubOperator(str(tmp_path), num_chips=4, minors=[2, 0, 3, 1])
    assert [c.device_path for c in op.devices()] == [
        "/dev/nvidia2", "/dev/nvidia0", "/dev/nvidia3", "/dev/nvidia1"]
    assert op.topology.total_cores == 4 * 132
    op.set_unhealthy([1])
    assert op.healthy_indexes() == {0, 2, 3}
    assert op.origin_ts("unhealthy") is not None
    op.set_utilization({0: 50.0}, hbm_used={0: 7})
    op.fail_utilization([3])
    assert op.utilization() == {
        0: {"duty_cycle_percent": 50.0, "hbm_used_bytes": 7},
        3: {"error": "injected telemetry failure"}}
    op.clear_utilization()
    assert op.utilization() == {}
    op.set_maintenance_event("TERMINATE_ON_HOST_MAINTENANCE")
    op.set_preempted(True)
    assert op.maintenance_event() == "TERMINATE_ON_HOST_MAINTENANCE"
    assert op.preempted()
    with pytest.raises(ValueError):
        StubOperator(str(tmp_path), num_chips=2, minors=[1, 1])


def test_exclusive_forwards_health_where_the_agents_does_not(tmp_path):
    """The agent's ExclusiveOperator inherits healthy_indexes from its
    base, so whole-chip mode reads every chip healthy; the port's
    forwards the inner operator's health."""
    from elastic_tpu_agent.tpu import ExclusiveOperator as AgentExclusive
    from elastic_tpu_agent.tpu import StubOperator as AgentStub
    from elastic_tpu_agent_torch.device import ExclusiveOperator

    agent_inner = AgentStub(str(tmp_path / "a"), "v5litepod-4")
    port_inner = StubOperator(str(tmp_path / "p"), num_chips=4)
    for inner in (agent_inner, port_inner):
        inner.set_unhealthy([1])
    assert AgentExclusive(agent_inner).healthy_indexes() == {0, 1, 2, 3}
    port = ExclusiveOperator(port_inner)
    assert port.healthy_indexes() == {0, 2, 3}
    assert port.virtual_nodes is False and port.check("any")
    assert port.topology is port_inner.topology


# -- qos: the port's copy against the agent's -----------------------------

GiB = 1024 * MiB
H100 = 81559 * MiB
QOS_CASES = [
    ({}, None, None, None, None),
    ({}, None, 20 * GiB, H100, 25),
    ({}, None, H100 // 4, H100, 25),
    ({}, None, 2 * H100, H100, 100),                        # over-grant
    ({}, None, "8192", H100, "10"),                         # numeric text
    ({}, None, 8 * GiB, str(H100), 10),                     # text card size
    ({}, None, "lots", H100, "many"),                       # non-numeric
    ({}, None, 0, H100, -3),                                # non-positive
    ({}, None, 8 * GiB, None, 0),                           # no card size
    ({"elasticgpu.io/qos-hbm-limit-bytes": str(4 * GiB)}, None, 8 * GiB,
     H100, 50),                                             # cap below
    ({"elasticgpu.io/qos-hbm-limit-bytes": str(99 * GiB)}, None, 8 * GiB,
     H100, 50),                                             # cap above
    ({"elasticgpu.io/qos-hbm-limit-bytes": "4G"}, None, 8 * GiB, H100,
     50),                                                   # malformed
    ({"elasticgpu.io/qos-hbm-limit-bytes": str(GiB)}, None, None, H100,
     50),                                                   # nothing to cap
    ({"elasticgpu.io/qos-core-units": "10"}, None, None, None, 25),
    ({"elasticgpu.io/qos-core-units": "40"}, None, None, None, 25),
    ({"elasticgpu.io/qos-core-units": "-5"}, None, None, None, 25),
    ({"elasticgpu.io/qos-core-units": "ten"}, None, None, None, 25),
    ({"elasticgpu.io/qos-core-units": "10"}, None, None, None, None),
    ({"elasticgpu.io/qos-priority": "HIGH"}, None, None, None, 25),
    ({"elasticgpu.io/qos-priority": "urgent"}, None, None, None, 25),
    ({}, {"spec": {"priorityClassName": "team-high-pri"}}, None, None, 5),
    ({}, {"spec": {"priorityClassName": "batch"}}, None, None, 5),
    ({"elasticgpu.io/qos-priority": "low"},
     {"spec": {"priorityClassName": "high"}}, 8 * GiB, H100, 5),
]


@pytest.mark.parametrize("annotations,pod,hbm,chip_hbm,units", QOS_CASES)
def test_qos_env_equals_the_agents(annotations, pod, hbm, chip_hbm, units):
    kw = dict(pod_spec=pod, hbm_limit_bytes=hbm, chip_hbm_bytes=chip_hbm,
              core_units=units)

    def outcome(fn):
        try:
            return fn(dict(annotations), **kw)
        except Exception as e:  # noqa: BLE001 - both must fail alike
            return type(e)

    assert outcome(port_qos.qos_env) == outcome(agent_qos.qos_env)
    assert port_qos.pod_priority(annotations, pod) == \
        agent_qos.pod_priority(annotations, pod)


@pytest.mark.parametrize("value", ["true", "Yes", " 1 ", "enabled", "no",
                                   "", "sure"])
def test_repartition_opt_in_equals_the_agents(value):
    ann = {AnnotationRepartition: value}
    assert port_qos.repartition_opt_in(ann) == agent_qos.repartition_opt_in(
        ann)


def test_qos_keys_are_the_agents():
    for name in ("AnnotationQoSPriority", "AnnotationQoSCoreUnits",
                 "AnnotationQoSHBMLimit", "EnvQoSCoreUnits",
                 "EnvQoSHBMLimit", "EnvQoSHBMFraction", "EnvQoSPriority"):
        assert getattr(port_qos, name) == getattr(agent_qos, name)
    assert port_qos.AnnotationRepartition == AnnotationRepartition


def test_visibility_env_names_cards_by_uuid(tmp_path):
    chips = StubOperator(str(tmp_path), num_chips=4,
                         minors=[2, 0, 3, 1]).devices()
    env = port_qos.visibility_env([chips[2], chips[0]])
    assert env == {"CUDA_VISIBLE_DEVICES": f"{chips[2].uuid},{chips[0].uuid}"}


PROBE = r"""
import sys
# any `import torch` (or grpc, protobuf, requests) now raises
for blocked in ("torch", "grpc", "google.protobuf", "requests"):
    sys.modules[blocked] = None
import elastic_tpu_agent_torch.device as d
from elastic_tpu_agent_torch.device import exclusive, nvidia, operator, qos
from elastic_tpu_agent_torch.device import stub, topology
# the node agent that builds the operators, on the same terms
from elastic_tpu_agent_torch import cli, manager, reconciler, supervisor
from elastic_tpu_agent_torch import kube, storage
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("elastic_tpu_agent", "jax")
                or (m.split(".")[0] in ("torch", "grpc", "requests")
                    or m.startswith("google.protobuf"))
                and sys.modules[m] is not None)
print(leaked)
"""


def test_device_layer_imports_neither_torch_nor_the_agent():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
