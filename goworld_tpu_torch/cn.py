# -*- coding: utf-8 -*-
"""goworld_tpu_torch 中文文档模块（文档专用，对应参考实现的 ``cn/goworld_cn.go:1-30``，
该包同样只承载中文 API 说明；本模块描述 PyTorch/CUDA 移植版，并原样转出公开 API）。

架构概览
========

goworld_tpu_torch 是 goworld_tpu 的 PyTorch 与 CUDA 移植版，世界状态运行在一张
NVIDIA H100 显卡上。一套部署由三种进程组成：

- **dispatcher（转发器）**：集群的消息路由中心。维护 EntityID 到 game 的路由表，
  对正在迁移或加载中的实体按序排队消息；多个 dispatcher 以 EntityID 哈希分片，
  组成星型拓扑。
- **gate（网关）**：终结客户端连接（TCP / WebSocket / KCP，可选 TLS 与 snappy 或
  zlib 压缩），把客户端上行的位置同步打包成 32 字节定长记录批量转发，并把下行
  同步按客户端重新分组下发。记录编解码、KCP 重传状态机与 snappy 编解码由
  ``goworld_tpu_torch/native/`` 下的 C++ 核心完成（首次使用时编译）。
- **game（游戏进程）**：承载全部游戏逻辑。"世界滴答"（tick）在显卡上执行：实体
  状态存放在 SoA（结构体数组）张量里，客户端输入经向量化散射写入，NPC 行为、
  移动积分、AOI 扫描、兴趣集增量、同步记录收集都在设备上完成；AOI 的按格计数
  排序与融合邻域扫描是为 Hopper（``sm_90a``）手写的 CUDA 内核。

多空间与巨型空间（megaspace）的全部分片都放在同一张显卡上：跨分片的实体迁移在
tick 边界上完成行交换；巨型空间把一个逻辑空间切成 XZ 平面瓦片，邻域信息经
光环（halo）交换内核传递。多控制器（多进程）游戏尚未移植（见 ROADMAP.md）。

编程模型
========

逻辑开发沿用"空间与实体"（Space & Entity）模型：

- 客户端登录后，会在某个 game 上创建一个启动实体（默认 ``Account``），即
  ClientOwner。登录校验通过后，通常创建 ``Avatar`` 并调用
  ``give_client_to`` 把客户端交接给它。
- 实体可通过 ``enter_space`` 进入空间；目标空间在其他 game 上时，框架自动打包
  全部属性、定时器与客户端绑定并在目标进程重建实体，对开发者透明。
- 属性以 ``MapAttr``/``ListAttr`` 响应式树维护：每次修改按根路径生成增量并
  自动同步给对应客户端（``client`` / ``allclients`` 标记决定受众；
  ``persistent`` 决定落盘）。
- 游戏逻辑运行在单一逻辑线程上（网络 IO 在独立线程），因此逻辑代码无需加锁，
  也绝不能调用阻塞系统调用；耗时工作交给异步工作组（``utils/asyncwork``）。
- 游戏脚本调用 ``goworld_tpu_torch.run()``：默认把世界放在显卡上，没有显卡时
  报错；测试脚本传 ``device="cpu"``。

运维与容灾
==========

``python -m goworld_tpu_torch start|stop|reload|status|watchdog|build <目录>``：
``reload`` 对 game 发送冻结信号（SIGHUP），全量快照落盘后以 ``-restore``
原地重启；``watchdog`` 周期巡检，发现崩溃的 game 时从最新快照（冻结文件或
周期检查点 ``checkpoint_interval``）恢复重启；``build`` 预先编译 C++ 核心。
每个进程可配置 ``http_port`` 调试端点（``/metrics``、``/audit``、
``/profile`` 用 torch.profiler 采集 CPU 与 CUDA 轨迹等）。KV 注册表（kvreg）、
KVDB、实体持久化、发布订阅、分片服务实体等与参考实现能力一一对应。

本模块只是文档与转出口；全部符号来自 :mod:`goworld_tpu_torch.api`。
"""

from goworld_tpu_torch.api import *  # noqa: F401,F403 — 文档性转出（与参考 cn 包一致）
from goworld_tpu_torch.api import __all__  # noqa: F401
