"""Fixed tensor layout shared by the cluster-state database and pod batches.

Everything the solver touches has a static, padded shape; `Capacities`
fixes those shapes. Units (chosen so common values are exact in float32):
- cpu: milli-cores
- memory / storage: MiB (keeps terabyte-range clusters inside float32's
  2^24 exact-integer window)
- gpu / pods: counts
"""

from __future__ import annotations

from dataclasses import dataclass

MEM_UNIT = 2**20  # bytes per device-side memory unit (MiB)


class Resource:
    """Row indices of the resource axis."""

    PODS = 0
    CPU = 1        # milli-cores
    MEMORY = 2     # MiB
    GPU = 3        # count (alpha.kubernetes.io/nvidia-gpu)
    SCRATCH = 4    # MiB (storage.kubernetes.io/scratch)
    OVERLAY = 5    # MiB (storage.kubernetes.io/overlay)
    COUNT = 6

    # v1 resource-name -> (row, converter kind)
    NAMES = {
        "pods": (PODS, "count"),
        "cpu": (CPU, "milli"),
        "memory": (MEMORY, "mem"),
        "alpha.kubernetes.io/nvidia-gpu": (GPU, "count"),
        "storage.kubernetes.io/scratch": (SCRATCH, "mem"),
        "storage.kubernetes.io/overlay": (OVERLAY, "mem"),
    }


class Effect:
    """Taint-effect codes (0 reserved for empty slot)."""

    NONE = 0
    NO_SCHEDULE = 1
    PREFER_NO_SCHEDULE = 2
    NO_EXECUTE = 3

    NAMES = {"NoSchedule": NO_SCHEDULE, "PreferNoSchedule": PREFER_NO_SCHEDULE,
             "NoExecute": NO_EXECUTE}


class TolOp:
    """Toleration operator codes (0 reserved for empty slot)."""

    NONE = 0
    EQUAL = 1
    EXISTS = 2


class ReqOp:
    """NodeSelectorRequirement operators (labels.Requirement.Matches
    semantics: NotIn/DoesNotExist are satisfied by a missing key)."""

    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"

    ALL = (IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT)


class Condition:
    """Bits of the per-node condition mask. Bit set == the *bad* state, so an
    all-zero mask is a healthy schedulable node."""

    NOT_READY = 1 << 0
    MEMORY_PRESSURE = 1 << 1
    DISK_PRESSURE = 1 << 2
    NETWORK_UNAVAILABLE = 1 << 3
    OUT_OF_DISK = 1 << 4
    UNSCHEDULABLE = 1 << 5


# Topology keys interned into the per-node topology table, in row order.
# Slots 0-2 are the default failure domains; slot 3 is the virtual
# (zone, region) composite and slot 4 the virtual GetZoneKey domain.
TOPOLOGY_KEYS = (
    "kubernetes.io/hostname",
    "failure-domain.beta.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/region",
)
TOPO_HOSTNAME = 0
TOPO_ZONE = 1
TOPO_REGION = 2
TOPO_ZONE_REGION = 3
TOPO_SPREAD_ZONE = 4
FIRST_CUSTOM_TOPO = 5

# Sentinel topology-slot codes of affinity terms.
TKEY_INVALID = -1        # empty/uninternable topologyKey on a required term
TKEY_DEFAULT_UNION = -2  # empty topologyKey on a preferred term: any default domain


class TermKind:
    """Carried pod-affinity-term kinds (the existing-pod side of inter-pod
    matching and its symmetric weighting)."""

    ANTI_REQ = 0   # required anti-affinity: predicate, hard fail
    AFF_REQ = 1    # required affinity: priority, weight = hardPodAffinityWeight
    AFF_PREF = 2   # preferred affinity: priority, +weight
    ANTI_PREF = 3  # preferred anti-affinity: priority, -weight


class VolType:
    """Attachable-volume type codes (EMPTY marks a free attach slot)."""

    EBS = 0
    GCE = 1
    AZURE = 2
    ANY = 3
    EMPTY = -1


# Scoring-time defaults for pods with no requests (priorities/util/non_zero.go).
DEFAULT_NONZERO_CPU_MILLI = 100.0
DEFAULT_NONZERO_MEM_MIB = 200.0 * 1024 * 1024 / MEM_UNIT  # 200 MB in MiB

MAX_PRIORITY = 10  # schedulerapi.MaxPriority


@dataclass(frozen=True)
class Capacities:
    """Static padding capacities: the shapes of every state and batch
    tensor. The `*_universe` capacities size the interned matching
    universes (distinct selector terms, taints, ...), so matching over
    (P x N) is a product of one-hot rows with membership matrices."""

    num_nodes: int = 1024          # N: node axis
    batch_pods: int = 256          # P: pending pods per solver batch
    selector_universe: int = 128   # US: distinct nodeSelector key=value terms
    taint_universe: int = 64       # UT: distinct (key, value, effect) taints
    port_universe: int = 64        # UP: distinct host ports in use
    req_universe: int = 64         # UR: distinct NodeSelectorRequirements
    podsel_universe: int = 32      # UQ: distinct (namespaces, labelSelector)
    term_universe: int = 32        # UE: distinct carried pod-affinity terms
    domain_universe: int = 64      # D: domains per non-hostname topology slot
    toleration_slots: int = 8      # tolerations per pod
    topology_slots: int = 8        # 3 defaults + 2 virtual + custom keys
    affinity_terms: int = 4        # required node-affinity OR-terms per pod
    pref_terms: int = 4            # preferred node-affinity terms per pod
    interpod_slots: int = 4        # required pod-(anti-)affinity terms per pod
    interpod_pref_slots: int = 4   # preferred pod-(anti-)affinity terms per pod
    volume_universe: int = 32      # UV: distinct disk-conflict atoms
    attach_universe: int = 32      # UA: distinct attachable-volume atoms
    image_universe: int = 64       # UI: distinct container-image names
    avoid_universe: int = 16       # UO: distinct preferAvoidPods signatures
    volsel_universe: int = 16      # UVS: distinct PV node-affinity selectors
    victim_slots: int = 16         # S: preemption victim candidates per node


class CapacityError(ValueError):
    """An object does not fit the static tensor capacities."""
