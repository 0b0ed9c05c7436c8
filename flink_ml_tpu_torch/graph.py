"""Graph, GraphBuilder and GraphModel: a DAG of stages.

Port of flink_ml_tpu/graph.py (the reference's builder/GraphBuilder.java:
39-398, Graph.java:54-150, GraphModel.java:50-145, GraphNode.java,
TableId.java, GraphExecutionHelper.java). Symbolic TableIds wire the
stages' inputs and outputs; an estimator node fits on its estimator inputs
and transforms its model inputs (which may be other tables); model-data
edges (`get_model_data_from_estimator`/`_model`, `set_model_data_on_
estimator`/`_model`) carry model data through the graph. A node runs once
every table it needs exists, so the order of the builder's calls does not
matter.

`Graph.fit` gives a GraphModel over new nodes holding the fitted models
and leaves the Graph as it was, so it fits again (ROADMAP C.12: the JAX
package's fit replaces the estimators in the Graph's own nodes). Save and
load keep the JAX package's layout: each node's stage under
`stages/{nodeId}`, the topology in the metadata; the className is the
reference's (`org.apache.flink.ml.builder.Graph`), so a graph saved by
either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from . import config
from .api import AlgoOperator, Estimator, Model, Stage
from .table import Table
from .utils import read_write


class TableId:
    """A symbolic table of the graph (builder/TableId.java)."""

    def __init__(self, table_id: int):
        self.table_id = int(table_id)

    def __eq__(self, other):
        return isinstance(other, TableId) and other.table_id == self.table_id

    def __hash__(self):
        return hash(self.table_id)

    def __repr__(self):
        return f"TableId({self.table_id})"


class GraphNode:
    """One stage and its wiring (builder/GraphNode.java:33-68)."""

    ESTIMATOR = "ESTIMATOR"
    ALGO_OPERATOR = "ALGO_OPERATOR"

    def __init__(
        self,
        node_id: int,
        stage: Stage,
        stage_type: str,
        estimator_input_ids: Optional[List[TableId]],
        algo_op_input_ids: List[TableId],
        output_ids: List[TableId],
        input_model_data_ids: Optional[List[TableId]] = None,
        output_model_data_ids: Optional[List[TableId]] = None,
    ):
        self.node_id = node_id
        self.stage = stage
        self.stage_type = stage_type
        self.estimator_input_ids = estimator_input_ids
        self.algo_op_input_ids = algo_op_input_ids
        self.output_ids = output_ids
        self.input_model_data_ids = input_model_data_ids
        self.output_model_data_ids = output_model_data_ids

    def with_stage(self, stage: Stage) -> "GraphNode":
        """The same wiring around another stage."""
        return GraphNode(self.node_id, stage, self.stage_type, self.estimator_input_ids,
                         self.algo_op_input_ids, self.output_ids, self.input_model_data_ids,
                         self.output_model_data_ids)

    def to_map(self) -> Dict:
        def ids(v):
            return None if v is None else [t.table_id for t in v]

        return {
            "nodeId": self.node_id,
            "stageType": self.stage_type,
            "estimatorInputIds": ids(self.estimator_input_ids),
            "algoOpInputIds": ids(self.algo_op_input_ids),
            "outputIds": ids(self.output_ids),
            "inputModelDataIds": ids(self.input_model_data_ids),
            "outputModelDataIds": ids(self.output_model_data_ids),
        }

    @staticmethod
    def from_map(m: Dict, stage: Stage) -> "GraphNode":
        return GraphNode(
            m["nodeId"],
            stage,
            m["stageType"],
            _ids(m["estimatorInputIds"]),
            _ids(m["algoOpInputIds"]),
            _ids(m["outputIds"]),
            _ids(m["inputModelDataIds"]),
            _ids(m["outputModelDataIds"]),
        )


def _ids(v):
    return None if v is None else [TableId(i) for i in v]


class GraphBuilder:
    """Builds a DAG of stages (builder/GraphBuilder.java:39)."""

    def __init__(self):
        self._next_table_id = 0
        self._next_node_id = 0
        self._max_output_table_num = 20
        self._nodes: Dict[int, GraphNode] = {}
        self._stage_to_node: Dict[int, GraphNode] = {}

    def set_max_output_table_num(self, value: int) -> "GraphBuilder":
        self._max_output_table_num = value
        return self

    def create_table_id(self) -> TableId:
        tid = TableId(self._next_table_id)
        self._next_table_id += 1
        return tid

    def _new_outputs(self) -> List[TableId]:
        return [self.create_table_id() for _ in range(self._max_output_table_num)]

    def _node_of(self, stage: Stage) -> GraphNode:
        """The stage's node, made at its first mention: model-data wiring
        may name a stage before `add_*` declares its inputs
        (getOrCreateAndCheckNode)."""
        key = id(stage)
        node = self._stage_to_node.get(key)
        if node is None:
            node = GraphNode(self._next_node_id, stage, None, None, None, self._new_outputs())
            self._next_node_id += 1
            self._nodes[node.node_id] = node
            self._stage_to_node[key] = node
        return node

    def add_algo_operator(self, algo_op: AlgoOperator, *inputs: TableId) -> List[TableId]:
        node = self._node_of(algo_op)
        if node.algo_op_input_ids is not None:
            raise ValueError("Stage already added to this GraphBuilder")
        node.stage_type = GraphNode.ALGO_OPERATOR
        node.algo_op_input_ids = list(inputs)
        return node.output_ids

    def add_estimator(
        self,
        estimator: Estimator,
        inputs: Sequence[TableId],
        model_transform_inputs: Optional[Sequence[TableId]] = None,
    ) -> List[TableId]:
        """Fit on `inputs`, then transform `model_transform_inputs` (by
        default the same tables) with the fitted model."""
        if model_transform_inputs is None:
            model_transform_inputs = inputs
        node = self._node_of(estimator)
        if node.algo_op_input_ids is not None:
            raise ValueError("Stage already added to this GraphBuilder")
        node.stage_type = GraphNode.ESTIMATOR
        node.estimator_input_ids = list(inputs)
        node.algo_op_input_ids = list(model_transform_inputs)
        return node.output_ids

    def set_model_data_on_estimator(self, estimator: Estimator, *inputs: TableId) -> None:
        self._node_of(estimator).input_model_data_ids = list(inputs)

    def set_model_data_on_model(self, model: Model, *inputs: TableId) -> None:
        self._node_of(model).input_model_data_ids = list(inputs)

    def get_model_data_from_estimator(self, estimator: Estimator) -> List[TableId]:
        node = self._node_of(estimator)
        node.output_model_data_ids = self._new_outputs()
        return node.output_model_data_ids

    def get_model_data_from_model(self, model: Model) -> List[TableId]:
        node = self._node_of(model)
        node.output_model_data_ids = self._new_outputs()
        return node.output_model_data_ids

    def build_estimator(
        self,
        inputs: Sequence[TableId],
        outputs: Sequence[TableId],
        input_model_data: Optional[Sequence[TableId]] = None,
        output_model_data: Optional[Sequence[TableId]] = None,
    ) -> "Graph":
        return Graph(
            list(self._nodes.values()),
            list(inputs),
            list(inputs),
            list(outputs),
            list(input_model_data) if input_model_data else None,
            list(output_model_data) if output_model_data else None,
        )

    def build_algo_operator(self, inputs: Sequence[TableId],
                            outputs: Sequence[TableId]) -> "GraphModel":
        return self.build_model(inputs, outputs)

    def build_model(
        self,
        inputs: Sequence[TableId],
        outputs: Sequence[TableId],
        input_model_data: Optional[Sequence[TableId]] = None,
        output_model_data: Optional[Sequence[TableId]] = None,
    ) -> "GraphModel":
        return GraphModel(
            list(self._nodes.values()),
            list(inputs),
            list(outputs),
            list(input_model_data) if input_model_data else None,
            list(output_model_data) if output_model_data else None,
        )


def _execute(nodes: List[GraphNode], env: Dict[TableId, Table], fit_mode: bool) -> List[GraphNode]:
    """Run each node once the tables it needs are in `env`, adding its
    outputs (GraphExecutionHelper). Returns the nodes as run: in fit mode an
    estimator node's copy holds its fitted model."""
    ran: Dict[int, GraphNode] = {}
    pending = list(nodes)
    progress = True
    while pending and progress:
        progress = False
        remaining = []
        for node in pending:
            needed = list(node.algo_op_input_ids)
            if fit_mode and node.estimator_input_ids is not None:
                needed += node.estimator_input_ids
            if node.input_model_data_ids:
                needed += node.input_model_data_ids
            if not all(t in env for t in needed):
                remaining.append(node)
                continue
            ran[node.node_id] = _run_node(node, env, fit_mode)
            progress = True
        pending = remaining
    if pending:
        raise ValueError(
            f"Graph has unsatisfiable dependencies for nodes {[n.node_id for n in pending]}")
    return [ran[n.node_id] for n in nodes]


def _run_node(node: GraphNode, env: Dict[TableId, Table], fit_mode: bool) -> GraphNode:
    stage = node.stage
    if fit_mode and node.stage_type == GraphNode.ESTIMATOR:
        stage = stage.fit(*[env[t] for t in node.estimator_input_ids])
        node = node.with_stage(stage)
    if node.input_model_data_ids:
        stage.set_model_data(*[env[t] for t in node.input_model_data_ids])
    outputs = stage.transform(*[env[t] for t in node.algo_op_input_ids])
    for tid, table in zip(node.output_ids, outputs):
        env[tid] = table
    if node.output_model_data_ids:
        for tid, table in zip(node.output_model_data_ids, stage.get_model_data()):
            env[tid] = table
    return node


def _save_graph(stage, path: str, nodes, id_lists: Dict[str, Optional[List[TableId]]]):
    extra = {
        "nodes": [n.to_map() for n in nodes],
        **{k: (None if v is None else [t.table_id for t in v]) for k, v in id_lists.items()},
    }
    read_write.save_metadata(stage, path, extra_metadata=extra)
    for node in nodes:
        node.stage.save(os.path.join(path, "stages", str(node.node_id)))


def _load_graph_nodes(path: str, metadata: Dict) -> List[GraphNode]:
    nodes = []
    for m in metadata["nodes"]:
        stage = read_write.load_stage(os.path.join(path, "stages", str(m["nodeId"])))
        nodes.append(GraphNode.from_map(m, stage))
    return nodes


class Graph(Estimator):
    """An Estimator DAG (builder/Graph.java:54)."""

    checkpointable = False
    checkpoint_reason = (
        "composite stage: each contained estimator snapshots its own "
        "fit through config.iteration_checkpoint_dir; the graph itself holds no training state"
    )

    def __init__(
        self,
        nodes: List[GraphNode],
        estimator_input_ids: List[TableId],
        model_input_ids: List[TableId],
        output_ids: List[TableId],
        input_model_data_ids: Optional[List[TableId]],
        output_model_data_ids: Optional[List[TableId]],
    ):
        self._nodes = list(nodes)
        self._estimator_input_ids = list(estimator_input_ids)
        self._model_input_ids = list(model_input_ids)
        self._output_ids = list(output_ids)
        self._input_model_data_ids = input_model_data_ids
        self._output_model_data_ids = output_model_data_ids

    def fit(self, *inputs: Table) -> "GraphModel":
        config.device()  # an entry point: no silent CPU without a request
        env: Dict[TableId, Table] = dict(zip(self._estimator_input_ids, inputs))
        fitted = _execute(self._nodes, env, fit_mode=True)
        return GraphModel(
            fitted,
            self._model_input_ids,
            self._output_ids,
            self._input_model_data_ids,
            self._output_model_data_ids,
        )

    def save(self, path: str) -> None:
        _save_graph(self, path, self._nodes, {
            "estimatorInputIds": self._estimator_input_ids,
            "modelInputIds": self._model_input_ids,
            "outputIds": self._output_ids,
            "inputModelDataIds": self._input_model_data_ids,
            "outputModelDataIds": self._output_model_data_ids,
        })

    @classmethod
    def load(cls, path: str) -> "Graph":
        metadata = read_write.load_metadata(path)
        return Graph(
            _load_graph_nodes(path, metadata),
            _ids(metadata["estimatorInputIds"]),
            _ids(metadata["modelInputIds"]),
            _ids(metadata["outputIds"]),
            _ids(metadata["inputModelDataIds"]),
            _ids(metadata["outputModelDataIds"]),
        )


class GraphModel(Model):
    """A Model or AlgoOperator DAG (builder/GraphModel.java:50)."""

    fusable = False
    fusable_reason = "composite stage: executes a DAG of member stages; fusion applies inside each member's own transform"

    def __init__(
        self,
        nodes: List[GraphNode],
        input_ids: List[TableId],
        output_ids: List[TableId],
        input_model_data_ids: Optional[List[TableId]],
        output_model_data_ids: Optional[List[TableId]],
    ):
        self._nodes = list(nodes)
        self._input_ids = list(input_ids)
        self._output_ids = list(output_ids)
        self._input_model_data_ids = input_model_data_ids
        self._output_model_data_ids = output_model_data_ids
        self._model_data_tables: Optional[List[Table]] = None

    @property
    def nodes(self) -> List[GraphNode]:
        return self._nodes

    def set_model_data(self, *inputs: Table) -> "GraphModel":
        self._model_data_tables = list(inputs)
        return self

    def get_model_data(self) -> List[Table]:
        """The tables of the designated model-data outputs in order
        (GraphModel.java:127-130), else every Model node's model data."""
        if self._output_model_data_ids:
            tables = []
            for tid in self._output_model_data_ids:
                for node in self._nodes:
                    if node.output_model_data_ids and tid in node.output_model_data_ids:
                        pos = node.output_model_data_ids.index(tid)
                        tables.append(node.stage.get_model_data()[pos])
                        break
                else:
                    raise ValueError(f"No node produces model data table {tid}")
            return tables
        tables = []
        for node in self._nodes:
            if isinstance(node.stage, Model):
                tables.extend(node.stage.get_model_data())
        return tables

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()
        env: Dict[TableId, Table] = dict(zip(self._input_ids, inputs))
        if self._input_model_data_ids and self._model_data_tables:
            env.update(zip(self._input_model_data_ids, self._model_data_tables))
        _execute(self._nodes, env, fit_mode=False)
        return [env[t] for t in self._output_ids]

    def save(self, path: str) -> None:
        _save_graph(self, path, self._nodes, {
            "estimatorInputIds": None,
            "modelInputIds": self._input_ids,
            "outputIds": self._output_ids,
            "inputModelDataIds": self._input_model_data_ids,
            "outputModelDataIds": self._output_model_data_ids,
        })

    @classmethod
    def load(cls, path: str) -> "GraphModel":
        metadata = read_write.load_metadata(path)
        return GraphModel(
            _load_graph_nodes(path, metadata),
            _ids(metadata["modelInputIds"]),
            _ids(metadata["outputIds"]),
            _ids(metadata["inputModelDataIds"]),
            _ids(metadata["outputModelDataIds"]),
        )
